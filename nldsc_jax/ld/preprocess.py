"""On-device genotype preprocessing (jitted JAX).

Fused, embarrassingly-parallel per-SNP pipeline replacing the reference's
serial per-SNP C++ decode (``encoder.h:91-134``): means/MAF from non-missing,
mean imputation, dominance residualization (1-D OLS), population-variance
standardization.  All formulas are the *centered* algebraic equivalents of
the reference's raw-moment forms (identical in exact arithmetic, better
conditioned in f32).

Input genotypes are int8 codes {0,1,2,-1}; sample-axis padding uses -1
(missing), which mean-imputes then standardizes to exactly 0, so padded
columns contribute nothing to any dot product.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("n_samples", "n_pad", "pad_val"))
def unpack_bed(raw: jax.Array, n_samples: int, n_pad: int,
               pad_val: int, col0=0) -> jax.Array:
    """Device-side 2-bit PLINK .bed unpack: (M, bytes_per_snp) uint8 →
    (M, n_pad) int8 genotype codes.

    The default ingestion path: shipping packed bytes costs 4× less
    host→device bandwidth than int8 codes, and the unpack is a trivial
    elementwise shift/mask
    (2-bit code → additive code via ``{0:0, 1:missing, 2:1, 3:2}``,
    matching :data:`nldsc_jax.io.plink._CODE_MAP`).  Columns whose GLOBAL
    sample index ≥ ``n_samples`` (the last byte's pad bitpairs and the
    lane padding to ``n_pad``) are forced to ``pad_val`` (0 for the
    no-missing fast path, −1 otherwise).

    ``col0`` (traced ok): global sample index of local column 0 — nonzero
    when ``raw`` is one sample-axis shard of a wider matrix (each shard
    unpacks its own byte range; see the sample-sharded engines).
    """
    m, bps = raw.shape
    rep = jnp.repeat(raw, 4, axis=1)                       # (M, 4·bps)
    shifts = jnp.tile(jnp.arange(4, dtype=jnp.uint8) * 2, bps)
    codes2 = (rep >> shifts[None, :]) & jnp.uint8(3)
    g = jnp.array([0, -1, 1, 2], jnp.int8)[codes2]
    if 4 * bps >= n_pad:
        g = g[:, :n_pad]
    else:
        g = jnp.pad(g, ((0, 0), (0, n_pad - 4 * bps)),
                    constant_values=pad_val)
    col = col0 + jnp.arange(n_pad, dtype=jnp.int32)[None, :]
    return jnp.where(col < n_samples, g, jnp.int8(pad_val))


@partial(jax.jit, static_argnames=("n_samples",))
def preprocess_block(genotypes: jax.Array, pos_ok: jax.Array, maf_thr: jax.Array,
                     n_samples: int) -> dict[str, jax.Array]:
    """Preprocess a block of SNPs.

    Parameters
    ----------
    genotypes : int8 (B, N_pad) — codes {0,1,2}; any negative = missing;
        sample padding must be negative.
    pos_ok : bool (B,) — position sentinel mask (False = skip row).
    maf_thr : scalar f32 — drop when ``maf <= maf_thr`` (encoder.h:120).
    n_samples : true N (static; population variance divides by this).

    Returns dict with f32 arrays:
      ``add``   (B, N_pad) standardized additive (0 rows where unusable),
      ``res``   (B, N_pad) standardized dominance residuals (0 where unusable
                 or residual sd == 0),
      ``maf``   (B,) folded MAF (NaN where position-skipped),
      ``rstd``  (B,) raw residual population sd (NaN where unusable or the
                 additive sd is zero — the reference propagates NaN there),
      ``usable`` (B,) bool, ``add_sd_zero`` (B,) bool.
    """
    g = genotypes
    n = jnp.float32(n_samples)

    valid = g >= 0
    gf = jnp.where(valid, g, 0).astype(jnp.float32)
    n_valid_raw = jnp.sum(valid, axis=1)
    # reference semantics for an ALL-missing SNP (encoder.h:99-122 with
    # n_nans==0): mean = 0/0 = NaN, the `maf <= thr` drop test is false for
    # NaN, so the SNP stays USABLE with NaN vectors that poison the
    # additive sums of every in-window pair, while its NaN residual sd
    # keeps it out of dominance.  We mark it usable + add_sd_zero (poison).
    all_missing = n_valid_raw == 0
    n_valid = jnp.maximum(n_valid_raw, 1).astype(jnp.float32)

    # integer-valued f32 sums are exact below 2^24
    add_sum = jnp.sum(gf, axis=1)
    dom_raw = jnp.where(valid, 2.0 * jnp.minimum(gf, 1.0), 0.0)
    dom_sum = jnp.sum(dom_raw, axis=1)

    add_mean = add_sum / n_valid
    dom_mean = dom_sum / n_valid

    f2 = add_mean * 0.5
    maf = jnp.minimum(f2, 1.0 - f2)
    usable = pos_ok & ((maf > maf_thr) | all_missing)

    # mean-impute missing AND sample padding; imputed values center to 0
    a = jnp.where(valid, gf, add_mean[:, None])
    a_c = a - add_mean[:, None]

    # dominance statistics via the exact class-count closed forms (the
    # elementwise d_c − slope·a_c formulation cancels catastrophically when
    # the residual sd is tiny — see ld_int8.dom_class_stats): the residual
    # is a function of the genotype code, r = v0/v1/v2 at codes 0/1/2 and
    # 0 at imputed positions.
    from .ld_int8 import dom_class_stats  # noqa: PLC0415
    c1 = jnp.sum(gf == 1.0, axis=1, dtype=jnp.float32)
    c2 = jnp.sum(gf == 2.0, axis=1, dtype=jnp.float32)
    c0 = n_valid - c1 - c2
    va, _slope, rvar_sum, v0, v1, v2 = dom_class_stats(c0, c1, c2)

    var_a_sum = va / n_valid                           # = n * population var
    add_sd = jnp.sqrt(var_a_sum / n)
    add_sd_zero = usable & ((va <= 0.0) | all_missing)

    r_c = jnp.where(
        valid,
        v0[:, None]
        + jnp.where(gf == 1.0, (v1 - v0)[:, None], 0.0)
        + jnp.where(gf == 2.0, (v2 - v0)[:, None], 0.0),
        0.0)
    rstd = jnp.sqrt(rvar_sum / n)

    inv_add_sd = jnp.where(add_sd > 0, 1.0 / jnp.where(add_sd > 0, add_sd, 1.0), 0.0)
    inv_rstd = jnp.where(rstd > 0, 1.0 / jnp.where(rstd > 0, rstd, 1.0), 0.0)

    row_ok = usable[:, None]
    add_out = jnp.where(row_ok, a_c * inv_add_sd[:, None], 0.0)
    res_out = jnp.where(row_ok & ~add_sd_zero[:, None], r_c * inv_rstd[:, None], 0.0)

    nan = jnp.float32(jnp.nan)
    maf_out = jnp.where(pos_ok & ~all_missing, maf, nan)
    rstd_out = jnp.where(usable & ~add_sd_zero, rstd, nan)

    return {
        "add": add_out,
        "res": res_out,
        "maf": maf_out,
        "rstd": rstd_out,
        "usable": usable,
        "add_sd_zero": add_sd_zero,
    }
