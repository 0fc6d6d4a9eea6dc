"""Integer-exact banded LD engine (int8 tensor-core path).

Genotypes are small integers, so every pairwise dot product the LD pass
needs is expressible through *integer* matmuls plus analytic corrections —
no f32 rounding inside the contraction at all.

Additive.  With ``g`` = additive codes (0 at missing/padding), ``u`` = valid
indicator, and per-SNP mean ``am``, the centered imputed vector is exactly
``a_c = g − am·u`` (imputed positions center to 0), so

  ac_ij = dot(a_c_i, a_c_j) = Sgg − am_i·Sug − am_j·Sgu + am_i·am_j·Suu
  r_add = ac_ij / (n · sd_i · sd_j)

where Sgg is an int8×int8→int32 matmul and Sgu/Sug/Suu derive exactly from
Sgm/Smg/Smm (``u = 1 − m``) plus per-SNP integer row sums.

Dominance — the cancellation-free formulation.  The dominance residual
``r = d_c − slope·a_c`` is a deterministic function of the genotype code:
it takes exactly three values v0/v1/v2 (one per code class; 0 at imputed
positions).  With class counts c0/c1/c2 (over valid samples) these values
have exact closed forms (derived by eliminating slope = cov/var in counts):

  Va = c0·c1 + 4·c0·c2 + c1·c2          ( = n_valid² · var(a), exact)
  v0 = −2·c1·c2 / Va    v1 = 4·c0·c2 / Va    v2 = −2·c0·c1 / Va
  slope = 2·c0·(c1 + 2·c2) / Va
  Σ r² = 4·c0·c1·c2 / Va                ( = n · rstd², exact)

so with class indicators e1 = h − g, e2 = g − h/2, e0 = u − h/2 (all exact
integer combinations of already-needed matmuls):

  dot(a_c_i, r_j) = Σ_c v_c_j · (dot(g_i, e_c_j) − am_i·dot(u_i, e_c_j))
  r_dom = that / (n · sd_i · rstd_j)

Why this beats the naive ``dc − slope_j·ac`` epilogue: the naive form
subtracts two O(n·sd_i·sd_j) quantities whose f32 roundings are amplified
by 1/rstd_j — observed l2d errors up to 3e-3 when a neighbor's residual sd
sits just above ``std_thr`` (round-1 root cause).  Here every term is
already O(n·sd_i·rstd_j): each class fluctuation ``dot(g_i,e_c) −
am_i·dot(u_i,e_c)`` is exact-integer minus one rounded product, and
|v_c| ≤ rstd·√(n/n_c), so the worst-case absolute error on r_dom is
~2·eps·(am_i/sd_i) ≲ 1e-5 — uniform in rstd.  (Each S** is exact: codes
≤ 2, |dot| ≤ 4·n_pad < 2^24; differences of exact f32 integers are exact.)

When the dataset has no missing genotypes (and zero sample padding), the
``m`` terms vanish: 2 integer matmuls per tile (Sgg, Sgh), same as before.
Speed: int8 tensor-core throughput is several-fold the f32 rate.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .ld_xla import finalize_outputs

#: per-SNP f32 scalar fields the engines consume, in stacking order
SCAL_FIELDS = ("am", "inv_sd", "inv_rstd", "v0", "v1", "v2",
               "gsum", "hsum", "cm")


def dom_class_stats(c0, c1, c2):
    """Exact closed forms of the dominance statistics in class counts.

    c0/c1/c2 : f32 exact-integer counts of genotype codes 0/1/2 among the
    valid (non-missing) samples of each SNP.  Returns
    ``(va, slope, rvar_sum, v0, v1, v2)`` where ``va = n_valid²·var(a)``,
    ``rvar_sum = Σ residual² ( = n·rstd²)`` and v0/v1/v2 are the residual
    values at codes 0/1/2.  All quantities are ratios of exact-integer
    products (~1e-7 relative error, no cancellation; reference semantics:
    ``tools.h:54-85``, ``encoder.h:130``).
    """
    va = c0 * c1 + 4.0 * c0 * c2 + c1 * c2
    inv = 1.0 / jnp.where(va > 0, va, 1.0)
    v0 = -2.0 * c1 * c2 * inv
    v1 = 4.0 * c0 * c2 * inv
    v2 = -2.0 * c0 * c1 * inv
    rvar_sum = 4.0 * c0 * c1 * c2 * inv
    slope = 2.0 * c0 * (c1 + 2.0 * c2) * inv
    return va, slope, rvar_sum, v0, v1, v2


def finish_preprocess_int8(n_valid_raw, c1, c2, cm, pos_ok, maf_thr,
                           n_samples: int, n_pad_cols: int):
    """Per-SNP scalar statistics from the three class counts.

    Shared by the in-core preprocess and the sample-sharded moment passes
    (where the counts arrive as psum'd shard partials).  Returns the
    per-SNP part of the engine input dict.
    """
    n = jnp.float32(n_samples)
    # reference semantics for an ALL-missing SNP: NaN mean -> the MAF drop
    # test is false -> stays usable as an additive-sum poison (see
    # preprocess.preprocess_block)
    all_missing = n_valid_raw == 0
    n_valid = jnp.maximum(n_valid_raw, 1.0)
    c0 = n_valid - c1 - c2
    gsum = c1 + 2.0 * c2
    hsum = 2.0 * (c1 + c2)
    am = gsum / n_valid

    f2 = am * 0.5
    maf = jnp.minimum(f2, 1.0 - f2)
    usable = pos_ok & ((maf > maf_thr) | all_missing)

    va, _slope, rvar_sum, v0, v1, v2 = dom_class_stats(c0, c1, c2)
    var_a_sum = va / n_valid                 # = Σ (a_imp − am)², exact form
    add_sd = jnp.sqrt(var_a_sum / n)
    add_sd_zero = usable & ((va <= 0.0) | all_missing)
    rstd = jnp.sqrt(rvar_sum / n)

    inv_sd = jnp.where((add_sd > 0) & usable,
                       1.0 / jnp.where(add_sd > 0, add_sd, 1.0), 0.0)
    inv_rstd = jnp.where((rstd > 0) & usable & ~add_sd_zero,
                         1.0 / jnp.where(rstd > 0, rstd, 1.0), 0.0)

    nan = jnp.float32(jnp.nan)
    return {
        "am": am, "inv_sd": inv_sd, "inv_rstd": inv_rstd,
        "v0": v0, "v1": v1, "v2": v2,
        "gsum": gsum, "hsum": hsum, "cm": cm,
        "maf": jnp.where(pos_ok & ~all_missing, maf, nan),
        "rstd": jnp.where(usable & ~add_sd_zero, rstd, nan),
        "usable": usable, "add_sd_zero": add_sd_zero,
    }


@partial(jax.jit, static_argnames=("n_samples", "assume_no_missing",
                                   "materialize_m"))
def preprocess_int8(genotypes: jax.Array, pos_ok: jax.Array, maf_thr: jax.Array,
                    n_samples: int,
                    assume_no_missing: bool = False,
                    materialize_m: bool = True) -> dict[str, jax.Array]:
    """Integer-path preprocessing: keep int8 arrays + per-SNP f32 scalars.

    Same statistics contract as :func:`preprocess.preprocess_block` but
    returns ``g``/``m``/``h`` int8 matrices instead of standardized f32
    rows.  Sample padding must be negative (treated as missing) — UNLESS
    ``assume_no_missing`` is set, in which case the caller guarantees no
    negative codes anywhere (zero-pad rows/columns instead): ``g`` is
    returned as-is (no masked copy) and the missing-indicator slot aliases
    ``g`` (it is never read by the no-missing kernel branches), removing
    two of the three O(M·N) int8 materializations.

    ``materialize_m=False`` skips the O(M·N) missing-indicator matrix even
    on the missing path (``m`` aliases ``g``, dead): for kernels that never
    read it — the clean scan of the split engine, whose corrections read
    the indicators only through the COMPACT contaminated rows
    (:func:`nldsc_jax.ld.ld_split.compact_missing_rows` rebuilds those from
    the raw codes) — or as a deferred materialization the caller performs
    itself with :func:`materialize_missing` once it decides it needs it.
    """
    g = genotypes

    if assume_no_missing:
        gq = g
        mq = g                      # alias; dead in no-missing kernels
        hq = (2 * jnp.minimum(g, 1)).astype(jnp.int8)
        cm = jnp.full(g.shape[0], jnp.float32(g.shape[1] - n_samples))
        n_valid_raw = jnp.full(g.shape[0], jnp.float32(n_samples))
    else:
        valid = g >= 0
        gq = jnp.where(valid, g, 0).astype(jnp.int8)
        mq = (~valid).astype(jnp.int8) if materialize_m else gq
        hq = jnp.where(valid, 2 * jnp.minimum(g, 1), 0).astype(jnp.int8)
        cm = jnp.sum(~valid, axis=1, dtype=jnp.float32)  # incl padding
        n_valid_raw = jnp.float32(g.shape[1]) - cm

    # every per-row moment is a closed form of THREE counts over the int8
    # codes (one fused read of g instead of five f32 passes)
    c1 = jnp.sum(gq == 1, axis=1, dtype=jnp.float32)
    c2 = jnp.sum(gq == 2, axis=1, dtype=jnp.float32)

    out = finish_preprocess_int8(n_valid_raw, c1, c2, cm, pos_ok, maf_thr,
                                 n_samples, g.shape[1])
    out.update({
        "g": gq, "m": mq, "h": hq,
        "has_missing": (jnp.array(False) if assume_no_missing
                        else jnp.any(cm > jnp.float32(g.shape[1]
                                                      - n_samples))),
    })
    return out


@jax.jit
def materialize_missing(genotypes: jax.Array) -> jax.Array:
    """Deferred full (M, N) int8 missing-indicator matrix from raw codes.

    The lazy counterpart of ``preprocess_int8(materialize_m=True)``'s
    ``m`` output — callers that preprocess with ``materialize_m=False``
    (hoping to route the split/clean kernels, which never read it) call
    this on the RAW codes only when the global missing epilogue is
    actually selected.
    """
    return (genotypes < 0).astype(jnp.int8)


def stack_scalars(pre: dict) -> jax.Array:
    """Stack the per-SNP engine scalars into one (M, 9) f32 matrix."""
    return jnp.stack([pre[k] for k in SCAL_FIELDS], axis=1)


def scal_views(mat: jax.Array, orient: str) -> dict[str, jax.Array]:
    """Broadcastable per-field views of a sliced (rows, 9) scalar matrix.

    ``orient='col'`` gives (rows, 1) pivot-side vectors, ``'row'`` gives
    (1, rows) neighbor-side vectors.
    """
    if orient == "row":
        return {k: mat[:, i][None, :] for i, k in enumerate(SCAL_FIELDS)}
    return {k: mat[:, i][:, None] for i, k in enumerate(SCAL_FIELDS)}


def make_idot(dot_dtype: str):
    """Contraction primitive: int8 or exact-bf16 single-pass."""
    dims = (((1,), (1,)), ((), ()))
    if dot_dtype == "int8":
        def idot(x, y):
            return lax.dot_general(
                x, y, dims,
                preferred_element_type=jnp.int32).astype(jnp.float32)
    else:
        def idot(x, y):
            return lax.dot_general(
                x.astype(jnp.bfloat16), y.astype(jnp.bfloat16), dims,
                preferred_element_type=jnp.float32)
    return idot


def _dom_dot(sgg, sgh, sgu, sug, suh, suu, am_i, v0_j, v1_j, v2_j):
    """dot(a_c_i, r_j) over the genotype classes of j (see module doc).

    Arguments are the EXACT f32-integer dots dot(g_i,·)/dot(u_i,·) against
    g_j / u_j / h_j; class indicators enter as exact integer combinations
    e1 = h − g, e2 = g − h/2, e0 = u − h/2 (h is even ⇒ halving exact).
    """
    a1 = (sgh - sgg) - am_i * (suh - sug)
    a2 = (sgg - 0.5 * sgh) - am_i * (sug - 0.5 * suh)
    a0 = (sgu - 0.5 * sgh) - am_i * (suu - 0.5 * suh)
    return v0_j * a0 + v1_j * a1 + v2_j * a2


def corr_from_dots(dots: dict, sc_i: dict, sc_j: dict, n, n_padf,
                   has_missing: bool, symmetric: bool = False):
    """(r_add, r_domA[, r_domB]) tiles from exact integer S-matrices.

    ``dots`` needs keys sgg, sgh (+ shg when symmetric; + sgm, smg, smm,
    smh (+ shm when symmetric) when has_missing).  ``sc_i``/``sc_j`` are
    broadcastable per-SNP scalar dicts (:func:`scal_views`).
    r_domA pairs (additive of pivot i) × (residual of neighbor j) — the
    reference orientation (ldscalc.h:38-41); r_domB the mirror.
    """
    sgg, sgh = dots["sgg"], dots["sgh"]
    am_i, am_j = sc_i["am"], sc_j["am"]
    if has_missing:
        # u = 1 − m: every u-dot is exact-integer arithmetic on S-matrices
        # and per-SNP integer sums
        sgu = sc_i["gsum"] - dots["sgm"]
        sug = sc_j["gsum"] - dots["smg"]
        suh = sc_j["hsum"] - dots["smh"]
        suu = n_padf - sc_i["cm"] - sc_j["cm"] + dots["smm"]
    else:
        sgu = sc_i["gsum"]
        sug = sc_j["gsum"]
        suh = sc_j["hsum"]
        suu = n

    ac = sgg - am_i * sug - am_j * sgu + am_i * am_j * suu
    r_add = ac * sc_i["inv_sd"] * sc_j["inv_sd"] / n
    dom_a = _dom_dot(sgg, sgh, sgu, sug, suh, suu, am_i,
                     sc_j["v0"], sc_j["v1"], sc_j["v2"])
    r_dom_a = dom_a * sc_i["inv_sd"] * sc_j["inv_rstd"] / n
    if not symmetric:
        return r_add, r_dom_a

    shg = dots["shg"]
    shu = (sc_i["hsum"] - dots["shm"]) if has_missing else sc_i["hsum"]
    # mirrored pair: same identity with the roles of i and j swapped
    # (dot(r_i, a_c_j); note dot(e_c_i, g_j) uses shg/sug, dot(e_c_i, u_j)
    # uses shu/sgu)
    dom_b = _dom_dot(sgg, shg, sug, sgu, shu, suu, am_j,
                     sc_i["v0"], sc_i["v1"], sc_i["v2"])
    r_dom_b = dom_b * sc_i["inv_rstd"] * sc_j["inv_sd"] / n
    return r_add, r_dom_a, r_dom_b


def corr_tiles(idot, g_i, m_i, h_i, g_j, m_j, h_j, sc_i, sc_j, n, n_padf,
               has_missing: bool, symmetric: bool = False,
               psum_axis: str | None = None):
    """Integer matmuls + :func:`corr_from_dots` epilogue in one call.

    ``h_i`` may be None when not symmetric.  Row operands are the pivot
    rows, column operands the neighbor band; shapes: g_i (B, Np),
    g_j/m_j/h_j (W, Np); scalars broadcast (B,1)/(1,W).

    ``psum_axis``: when the SAMPLE axis is sharded over a mesh axis of
    that name, each shard's matmuls are partial sums over its samples;
    one exact ``psum`` of the stacked integer S-tiles makes the epilogue
    inputs global (the per-SNP scalars must already be global).
    """
    dots = {"sgg": idot(g_i, g_j), "sgh": idot(g_i, h_j)}
    if symmetric:
        dots["shg"] = idot(h_i, g_j)
    if has_missing:
        dots["sgm"] = idot(g_i, m_j)
        dots["smg"] = idot(m_i, g_j)
        dots["smm"] = idot(m_i, m_j)
        dots["smh"] = idot(m_i, h_j)
        if symmetric:
            dots["shm"] = idot(h_i, m_j)
    if psum_axis is not None:
        names = list(dots)
        merged = lax.psum(jnp.stack([dots[k] for k in names]), psum_axis)
        dots = dict(zip(names, merged))
    return corr_from_dots(dots, sc_i, sc_j, n, n_padf, has_missing, symmetric)


@partial(jax.jit, static_argnames=("block_size", "band_k", "n_samples",
                                   "has_missing", "dot_dtype"))
def ld_scores_int8(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                   blk_lo, blk_hi, rsq_thr, annot=None, *, block_size: int,
                   band_k: int, n_samples: int, has_missing: bool,
                   dot_dtype: str = "int8"):
    """Banded LD pass on integer matmuls (same contract as ld_scores_xla).

    ``scal``: (M, 9) f32 per-SNP scalars (:func:`stack_scalars`).
    ``dot_dtype``: 'int8' (int8×int8→int32) or 'bf16'
    (bf16×bf16→f32 at single-pass rate).  BOTH are exact here: genotype
    codes {0,1,2} are exactly representable in bf16 and every partial sum
    is an integer below 2^24, so f32 accumulation never rounds (valid for
    N_pad ≤ 4M samples).

    ``annot``: optional f32 (M_pad, p) annotation matrix (padding rows 0).
    When given, each tile additionally contracts its masked adjusted-r²
    with the band's annotation slab — one extra skinny matmul per tile —
    and the return extends to ``(l2_annot, l2d_annot, l2, l2d, ws, wsd,
    wse)`` with the same sentinel semantics as
    :func:`nldsc_jax.ld.ld_xla.ld_scores_xla_annot`.
    """
    m_pad, n_pad_cols = g.shape
    assert n_pad_cols <= (1 << 22), "bf16-exact path requires N_pad <= 4M"
    n_blocks = m_pad // block_size
    B = block_size
    band_rows = min(band_k * B, m_pad)
    n = jnp.float32(n_samples)
    n_padf = jnp.float32(n_pad_cols)
    inv_n2 = 1.0 / (n - 2.0)
    idot = make_idot(dot_dtype)

    def pivot_block(b):
        r0 = b * B
        gi_rows = lax.dynamic_slice_in_dim(g, r0, B, axis=0)
        mi_rows = lax.dynamic_slice_in_dim(m, r0, B, axis=0)
        gi = r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo, r0, B)
        hi_i = lax.dynamic_slice_in_dim(hi, r0, B)
        usable_i = lax.dynamic_slice_in_dim(usable, r0, B)
        sc_i = scal_views(lax.dynamic_slice_in_dim(scal, r0, B, axis=0), "col")

        j0 = jnp.clip(blk_lo[b] * B, 0, m_pad - band_rows)
        gj_rows = lax.dynamic_slice_in_dim(g, j0, band_rows, axis=0)
        mj_rows = lax.dynamic_slice_in_dim(m, j0, band_rows, axis=0)
        hj_rows = lax.dynamic_slice_in_dim(h, j0, band_rows, axis=0)
        gj = j0 + jnp.arange(band_rows, dtype=jnp.int32)
        usable_j = lax.dynamic_slice_in_dim(usable, j0, band_rows)
        dom_ok_j = lax.dynamic_slice_in_dim(dom_ok, j0, band_rows)
        poison_j = lax.dynamic_slice_in_dim(add_sd_zero, j0, band_rows)
        sc_j = scal_views(lax.dynamic_slice_in_dim(scal, j0, band_rows,
                                                   axis=0), "row")

        r_add, r_dom = corr_tiles(
            idot, gi_rows, mi_rows, None, gj_rows, mj_rows, hj_rows,
            sc_i, sc_j, n, n_padf, has_missing)

        adj_add = r_add * r_add - (1.0 - r_add * r_add) * inv_n2
        adj_dom = r_dom * r_dom - (1.0 - r_dom * r_dom) * inv_n2

        valid_k = gj <= blk_hi[b] * B + (B - 1)
        in_win = ((gj[None, :] >= lo_i[:, None]) &
                  (gj[None, :] <= hi_i[:, None]) & valid_k[None, :])
        pair = in_win & usable_j[None, :] & usable_i[:, None]
        base = pair & (gj[None, :] != gi[:, None])
        dmask = base & dom_ok_j[None, :]
        basef = base.astype(jnp.float32)
        dmaskf = dmask.astype(jnp.float32)

        l2_p = jnp.sum(adj_add * basef, axis=1)
        l2d_p = jnp.sum(adj_dom * dmaskf, axis=1)
        ws_p = jnp.sum(base, axis=1).astype(jnp.int32)
        wsd_p = jnp.sum(dmask, axis=1).astype(jnp.int32)
        wse_p = jnp.sum((adj_dom > rsq_thr) & dmask, axis=1).astype(jnp.int32)
        poi_p = jnp.sum(pair & poison_j[None, :], axis=1).astype(jnp.int32)
        if annot is None:
            return l2_p, l2d_p, ws_p, wsd_p, wse_p, poi_p
        aj = lax.dynamic_slice_in_dim(annot, j0, band_rows, axis=0)
        # precision highest: a lower precision rounds adj r² to bf16 or
        # TF32 (~5e-3 error on the sums)
        l2a_p = jnp.dot(adj_add * basef, aj, precision="highest",
                        preferred_element_type=jnp.float32)
        l2da_p = jnp.dot(adj_dom * dmaskf, aj, precision="highest",
                         preferred_element_type=jnp.float32)
        return l2_p, l2d_p, ws_p, wsd_p, wse_p, poi_p, l2a_p, l2da_p

    accs = lax.map(pivot_block, jnp.arange(n_blocks, dtype=jnp.int32))
    l2_acc, l2d_acc, ws, wsd, wse, poison = (a.reshape(m_pad)
                                             for a in accs[:6])
    fin = finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poison,
                           usable, add_sd_zero)
    if annot is None:
        return fin
    p = annot.shape[1]
    l2_a, l2d_a = (a.reshape(m_pad, p) for a in accs[6:])
    nan = jnp.float32(jnp.nan)
    good = (usable & (poison == 0))[:, None]
    l2_a = jnp.where(good, annot + l2_a, nan)           # + self term
    l2d_bad = jnp.where(wsd > 0, nan, 0.0)[:, None]
    l2d_a = jnp.where(usable[:, None],
                      jnp.where(add_sd_zero[:, None], l2d_bad, l2d_a), nan)
    return (l2_a, l2d_a, *fin)


@partial(jax.jit, static_argnames=("block_size", "right_k", "n_samples",
                                   "has_missing", "dot_dtype"))
def ld_scores_int8_sym2(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                        blk_lo, blk_hi, rsq_thr, *, block_size: int,
                        right_k: int, n_samples: int, has_missing: bool,
                        dot_dtype: str = "int8"):
    """Two-pass symmetry-exploiting integer engine (no scan carry).

    Same pair algebra as :func:`ld_scores_int8_sym` (right half-band,
    bidirectional credit) but restructured to avoid the sequential
    ``lax.scan`` + full-length scatter carry that serializes that engine:

      pass 1 — ``lax.map`` over pivot blocks, each returning its ROW sums
               (B,) and its COLUMN-credit vectors (right_rows,) for the
               mirrored pairs; iterations carry nothing;
      pass 2 — one batched scatter-add folds all column-credit vectors at
               their block offsets (O(n_blocks · right_rows) VPU work).

    Matmul flops match the one-pass symmetric engine: 3 half-band integer
    matmuls per tile without missing data, 8 with.
    """
    m_pad, n_pad_cols = g.shape
    assert n_pad_cols <= (1 << 22)
    n_blocks = m_pad // block_size
    B = block_size
    right_rows = min(right_k * B, m_pad)
    n = jnp.float32(n_samples)
    n_padf = jnp.float32(n_pad_cols)
    inv_n2 = 1.0 / (n - 2.0)
    idot = make_idot(dot_dtype)

    def sl(v, at, size):
        return lax.dynamic_slice_in_dim(v, at, size)

    def pivot_block(b):
        r0 = b * B
        gi = r0 + jnp.arange(B, dtype=jnp.int32)
        g_i = lax.dynamic_slice_in_dim(g, r0, B, axis=0)
        m_i = lax.dynamic_slice_in_dim(m, r0, B, axis=0)
        h_i = lax.dynamic_slice_in_dim(h, r0, B, axis=0)
        lo_i = sl(lo, r0, B)[:, None]
        hi_i = sl(hi, r0, B)[:, None]
        usable_i = sl(usable, r0, B)[:, None]
        poison_i = sl(add_sd_zero, r0, B)[:, None]
        dom_ok_i = sl(dom_ok, r0, B)[:, None]
        sc_i = scal_views(lax.dynamic_slice_in_dim(scal, r0, B, axis=0), "col")

        j0 = jnp.minimum(r0, m_pad - right_rows)
        gj = j0 + jnp.arange(right_rows, dtype=jnp.int32)
        g_j = lax.dynamic_slice_in_dim(g, j0, right_rows, axis=0)
        m_j = lax.dynamic_slice_in_dim(m, j0, right_rows, axis=0)
        h_j = lax.dynamic_slice_in_dim(h, j0, right_rows, axis=0)
        usable_j = sl(usable, j0, right_rows)[None, :]
        poison_j = sl(add_sd_zero, j0, right_rows)[None, :]
        dom_ok_j = sl(dom_ok, j0, right_rows)[None, :]
        sc_j = scal_views(lax.dynamic_slice_in_dim(scal, j0, right_rows,
                                                   axis=0), "row")

        r_add, r_dom_a, r_dom_b = corr_tiles(
            idot, g_i, m_i, h_i, g_j, m_j, h_j, sc_i, sc_j, n, n_padf,
            has_missing, symmetric=True)

        adj_add = r_add * r_add - (1.0 - r_add * r_add) * inv_n2
        adj_dA = r_dom_a * r_dom_a - (1.0 - r_dom_a * r_dom_a) * inv_n2
        adj_dB = r_dom_b * r_dom_b - (1.0 - r_dom_b * r_dom_b) * inv_n2

        in_win = (gj[None, :] >= lo_i) & (gj[None, :] <= hi_i)
        upair = in_win & usable_j & usable_i
        fwd = gj[None, :] >= r0
        row_base = upair & fwd & (gj[None, :] != gi[:, None])
        col_base = upair & (gj[None, :] >= r0 + B)
        dmA = row_base & dom_ok_j
        dmB = col_base & dom_ok_i
        rowf = row_base.astype(jnp.float32)
        colf = col_base.astype(jnp.float32)
        dmAf = dmA.astype(jnp.float32)
        dmBf = dmB.astype(jnp.float32)

        rows = (
            jnp.sum(adj_add * rowf, axis=1),
            jnp.sum(row_base, axis=1).astype(jnp.int32),
            jnp.sum(upair & fwd & poison_j, axis=1).astype(jnp.int32),
            jnp.sum(adj_dA * dmAf, axis=1),
            jnp.sum(dmA, axis=1).astype(jnp.int32),
            jnp.sum((adj_dA > rsq_thr) & dmA, axis=1).astype(jnp.int32),
        )
        cols = (
            jnp.sum(adj_add * colf, axis=0),
            jnp.sum(col_base, axis=0).astype(jnp.int32),
            jnp.sum(upair & poison_i & (gj[None, :] >= r0 + B),
                    axis=0).astype(jnp.int32),
            jnp.sum(adj_dB * dmBf, axis=0),
            jnp.sum(dmB, axis=0).astype(jnp.int32),
            jnp.sum((adj_dB > rsq_thr) & dmB, axis=0).astype(jnp.int32),
        )
        return rows + cols + (j0,)

    outs = lax.map(pivot_block, jnp.arange(n_blocks, dtype=jnp.int32))
    rows, cols, j0s = outs[:6], outs[6:12], outs[12]
    # pass 2: fold column credits at each block's (clamped) offset
    idx = j0s[:, None] + jnp.arange(right_rows, dtype=jnp.int32)[None, :]

    def fold(row_parts, col_parts):
        full = row_parts.reshape(m_pad).astype(col_parts.dtype)
        return full.at[idx.reshape(-1)].add(col_parts.reshape(-1))

    l2_acc, ws, poison, l2d_acc, wsd, wse = (
        fold(r, c) for r, c in zip(rows, cols))
    return finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poison,
                            usable, add_sd_zero)


@partial(jax.jit, static_argnames=("block_size", "band_k", "right_k",
                                   "n_samples", "has_missing", "dot_dtype"))
def ld_scores_int8_sym(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                       blk_lo, blk_hi, rsq_thr, annot=None, *,
                       block_size: int, band_k: int, right_k: int,
                       n_samples: int, has_missing: bool,
                       dot_dtype: str = "int8"):
    """Symmetry-exploiting integer engine.

    Each pivot block multiplies only its RIGHT half-band; one tile yields
    *both* directions of every pair:

      additive     — ``ac`` is symmetric: row sums credit the pivot rows,
                     column sums credit the mirrored pairs;
      dominance A  — (pivot-row additive) × (col residual);
      dominance B  — (col additive) × (row residual), from ``Shg`` and the
                     transposed class decomposition.

    Half-band matmuls: 3 (Sgg, Sgh, Shg) without missing, 8 with — vs the
    full-band engine's 2 / 6 — a 4/3 (resp. 3/2) flop reduction.
    Intra-block pairs are fully covered by row-direction sums (both orders
    appear inside the tile); column-direction sums skip the intra tile.

    ``annot``: optional f32 (M_pad, p) annotation matrix — extends the
    return to ``(l2_annot, l2d_annot, l2, l2d, ws, wsd, wse)`` with the
    same sentinel semantics as :func:`ld_scores_int8`.

    ``band_k`` and ``blk_lo``/``blk_hi`` are accepted (and ignored) for
    call-site symmetry with :func:`ld_scores_int8` — the right band's
    geometry is fully determined by ``right_k``.
    """
    accs = sym_scan_segment(
        g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr,
        jnp.int32(0), annot, block_size=block_size, right_k=right_k,
        n_samples=n_samples, n_scan_blocks=g.shape[0] // block_size,
        has_missing=has_missing, dot_dtype=dot_dtype)
    (l2_acc, ws, poison, l2d_acc, wsd, wse) = accs[:6]
    fin = finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poison,
                           usable, add_sd_zero)
    if annot is None:
        return fin
    l2_a, l2d_a = accs[6:]
    return (*finalize_annot(l2_a, l2d_a, annot, usable, add_sd_zero,
                            poison, wsd), *fin)


def finalize_annot(l2_a, l2d_a, annot, usable, add_sd_zero, poison, wsd):
    """Sentinel semantics for the partitioned accumulators: + self-term,
    NaN rows per Q4 (same contract as ld_scores_xla_annot)."""
    nan = jnp.float32(jnp.nan)
    good = (usable & (poison == 0))[:, None]
    l2_a = jnp.where(good, annot + l2_a, nan)           # + self term
    l2d_bad = jnp.where(wsd > 0, nan, 0.0)[:, None]
    l2d_a = jnp.where(usable[:, None],
                      jnp.where(add_sd_zero[:, None], l2d_bad, l2d_a), nan)
    return l2_a, l2d_a


@partial(jax.jit, static_argnames=("block_size", "right_k", "n_samples",
                                   "n_scan_blocks", "has_missing",
                                   "dot_dtype"))
def sym_scan_segment(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                     rsq_thr, blk0, annot=None, *, block_size: int,
                     right_k: int, n_samples: int, n_scan_blocks: int,
                     has_missing: bool, dot_dtype: str = "int8"):
    """Credit accumulation of :func:`ld_scores_int8_sym` for the pivot
    blocks ``[blk0, blk0 + n_scan_blocks)`` only.

    Returns the six UN-finalized full-length credit vectors (l2, ws,
    poison, l2d, wsd, wse).  Segments tile the block range disjointly:
    summing segment outputs and applying :func:`finalize_outputs`
    reproduces the single-scan result (row credits are disjoint across
    segments; column credits overlap only additively — counters are exact
    integers in f32, the f32 score sums differ from the single-scan order
    by ≤1 ulp per overlap).  This is what lets the pipeline dispatch the
    pass in chunks and report real percent/ETA progress (reference UX:
    ``indicators.h`` per-SNP bar) without serializing on a host fetch of
    the full outputs.

    ``annot``: optional f32 (M_pad, p) annotation matrix.  Adds two
    (M_pad, p) accumulators to the return: per-annotation L2/L2D credit
    sums, via four skinny contractions per tile — the row direction
    contracts the masked adjusted-r² tile with the band's annotation
    slab, the mirrored column direction contracts its transpose with the
    pivot rows' annotations (reference per-pair semantics weighted by the
    NEIGHBOR's annotation: ``ldscalc.h:38-47``).
    """
    m_pad, n_pad_cols = g.shape
    assert n_pad_cols <= (1 << 22)
    B = block_size
    right_rows = min(right_k * B, m_pad)
    n = jnp.float32(n_samples)
    n_padf = jnp.float32(n_pad_cols)
    inv_n2 = 1.0 / (n - 2.0)
    idot = make_idot(dot_dtype)

    def sl(v, at, size):
        return lax.dynamic_slice_in_dim(v, at, size)

    def step(carry, b):
        (l2_f, ws_f, poi_f, l2d_f, wsd_f, wse_f) = carry[:6]
        r0 = b * B
        gi = r0 + jnp.arange(B, dtype=jnp.int32)
        g_i = lax.dynamic_slice_in_dim(g, r0, B, axis=0)
        m_i = lax.dynamic_slice_in_dim(m, r0, B, axis=0)
        h_i = lax.dynamic_slice_in_dim(h, r0, B, axis=0)
        lo_i = sl(lo, r0, B)[:, None]
        hi_i = sl(hi, r0, B)[:, None]
        usable_i = sl(usable, r0, B)[:, None]
        poison_i = sl(add_sd_zero, r0, B)[:, None]
        dom_ok_i = sl(dom_ok, r0, B)[:, None]
        sc_i = scal_views(lax.dynamic_slice_in_dim(scal, r0, B, axis=0), "col")

        j0 = jnp.minimum(r0, m_pad - right_rows)
        gj = j0 + jnp.arange(right_rows, dtype=jnp.int32)
        g_j = lax.dynamic_slice_in_dim(g, j0, right_rows, axis=0)
        m_j = lax.dynamic_slice_in_dim(m, j0, right_rows, axis=0)
        h_j = lax.dynamic_slice_in_dim(h, j0, right_rows, axis=0)
        usable_j = sl(usable, j0, right_rows)[None, :]
        poison_j = sl(add_sd_zero, j0, right_rows)[None, :]
        dom_ok_j = sl(dom_ok, j0, right_rows)[None, :]
        sc_j = scal_views(lax.dynamic_slice_in_dim(scal, j0, right_rows,
                                                   axis=0), "row")

        r_add, r_dom_a, r_dom_b = corr_tiles(
            idot, g_i, m_i, h_i, g_j, m_j, h_j, sc_i, sc_j, n, n_padf,
            has_missing, symmetric=True)

        adj_add = r_add * r_add - (1.0 - r_add * r_add) * inv_n2
        adj_dA = r_dom_a * r_dom_a - (1.0 - r_dom_a * r_dom_a) * inv_n2
        adj_dB = r_dom_b * r_dom_b - (1.0 - r_dom_b * r_dom_b) * inv_n2

        in_win = (gj[None, :] >= lo_i) & (gj[None, :] <= hi_i)
        upair = in_win & usable_j & usable_i
        fwd = gj[None, :] >= r0
        row_base = upair & fwd & (gj[None, :] != gi[:, None])
        col_base = upair & (gj[None, :] >= r0 + B)

        rowf = row_base.astype(jnp.float32)
        colf = col_base.astype(jnp.float32)
        dmA = row_base & dom_ok_j
        dmB = col_base & dom_ok_i
        dmAf = dmA.astype(jnp.float32)
        dmBf = dmB.astype(jnp.float32)

        def credit(full, at, vals):
            cur = lax.dynamic_slice_in_dim(full, at, vals.shape[0])
            return lax.dynamic_update_slice_in_dim(full, cur + vals, at, 0)

        l2_f = credit(credit(l2_f, r0, jnp.sum(adj_add * rowf, axis=1)),
                      j0, jnp.sum(adj_add * colf, axis=0))
        ws_f = credit(credit(ws_f, r0, jnp.sum(row_base, axis=1).astype(jnp.int32)),
                      j0, jnp.sum(col_base, axis=0).astype(jnp.int32))
        poi_f = credit(
            credit(poi_f, r0,
                   jnp.sum(upair & fwd & poison_j, axis=1).astype(jnp.int32)),
            j0, jnp.sum(upair & poison_i & (gj[None, :] >= r0 + B),
                        axis=0).astype(jnp.int32))

        l2d_f = credit(credit(l2d_f, r0, jnp.sum(adj_dA * dmAf, axis=1)),
                       j0, jnp.sum(adj_dB * dmBf, axis=0))
        wsd_f = credit(credit(wsd_f, r0, jnp.sum(dmA, axis=1).astype(jnp.int32)),
                       j0, jnp.sum(dmB, axis=0).astype(jnp.int32))
        wse_f = credit(
            credit(wse_f, r0,
                   jnp.sum((adj_dA > rsq_thr) & dmA, axis=1).astype(jnp.int32)),
            j0, jnp.sum((adj_dB > rsq_thr) & dmB, axis=0).astype(jnp.int32))

        if annot is None:
            return (l2_f, ws_f, poi_f, l2d_f, wsd_f, wse_f), None

        # partitioned credits: row direction weights by the BAND rows'
        # annotations, the mirrored column direction by the PIVOT rows'
        # (each pair weighted by its neighbor's annotation — ldscalc.h
        # per-pair semantics).  precision 'highest': a lower precision
        # rounds the adjusted r² operand to bf16 or TF32 (~5e-3 on the
        # sums).  These contractions sit on the scan's critical path,
        # which is why clean in-core annot routes full-band
        # (pipeline.py).
        # Column direction contracts over the PIVOT axis via dot_general
        # (no materialized transpose of the (B, right_rows) tiles).
        l2a_f, l2da_f = carry[6:]
        aj = lax.dynamic_slice_in_dim(annot, j0, right_rows, axis=0)
        ai = lax.dynamic_slice_in_dim(annot, r0, B, axis=0)

        def credit2(full, at, vals):
            cur = lax.dynamic_slice_in_dim(full, at, vals.shape[0], axis=0)
            return lax.dynamic_update_slice_in_dim(full, cur + vals, at, 0)

        # four skinny matmuls (stacking/concatenating the masked tiles to
        # merge launches would add copies of the tiles);
        # the column direction contracts dim 0 via dot_general so the
        # (B, right_rows) tiles are never transposed in memory
        dotp = partial(jnp.dot, precision="highest",
                       preferred_element_type=jnp.float32)

        def dot_ct(tile, a_piv):            # (B,W) tile ᵀ· (B,p) -> (W,p)
            return lax.dot_general(tile, a_piv, (((0,), (0,)), ((), ())),
                                   precision="highest",
                                   preferred_element_type=jnp.float32)

        l2a_f = credit2(credit2(l2a_f, r0, dotp(adj_add * rowf, aj)),
                        j0, dot_ct(adj_add * colf, ai))
        l2da_f = credit2(credit2(l2da_f, r0, dotp(adj_dA * dmAf, aj)),
                         j0, dot_ct(adj_dB * dmBf, ai))
        return (l2_f, ws_f, poi_f, l2d_f, wsd_f, wse_f, l2a_f, l2da_f), None

    zf = jnp.zeros(m_pad, jnp.float32)
    zi = jnp.zeros(m_pad, jnp.int32)
    init = (zf, zi, zi, zf, zi, zi)
    if annot is not None:
        za = jnp.zeros((m_pad, annot.shape[1]), jnp.float32)
        init = init + (za, za)
    carry, _ = lax.scan(
        step, init, blk0 + jnp.arange(n_scan_blocks, dtype=jnp.int32))
    return carry
