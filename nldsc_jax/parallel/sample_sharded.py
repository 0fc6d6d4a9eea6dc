"""Sample-axis (N) sharding — the "sequence parallel" dimension.

For UKB-scale N the genotype block row (N samples) can outgrow one chip's
HBM even with SNP streaming.  Here the SAMPLE axis is scattered over the
mesh instead: every device holds all SNP rows but only its sample columns,
and every dot product in the integer algebra is a sum over samples — so

  * per-SNP moments (counts, sums, second moments) are shard-partial sums
    combined with one ``psum`` (exact: integer partials);
  * each banded tile's S-matrices are shard-partial integer matmuls
    combined with a per-tile ``psum`` before the fused epilogue;
  * the epilogue is replicated (cheap VPU work) and outputs are identical
    on every shard — deterministic by construction.

Composes conceptually with SNP-axis sharding/streaming (2-D mesh) — that
combination is future work (TODO.md).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..ld.ld_xla import _tile_epilogue, finalize_outputs
from ..ld.ld_int8 import (corr_from_dots, finish_preprocess_int8, make_idot,
                          scal_views, stack_scalars)
from .mesh import SNP_AXIS


def shard_preprocess_int8(g, pos_ok, maf_thr, *, n_samples, n_pad_total,
                          axis):
    """Per-shard integer preprocessing with GLOBAL per-SNP statistics.

    ``g``: this shard's (rows, N_local) int8 codes (negative = missing,
    incl. sample padding).  The three class counts are shard-partial
    integer sums combined with one exact ``psum`` over mesh axis ``axis``;
    everything per-SNP that follows (:func:`finish_preprocess_int8`) is
    replicated.  Returns the engine ``pre`` dict with shard-LOCAL
    ``g``/``m``/``h`` matrices and global scalars.
    """
    valid = g >= 0
    gq = jnp.where(valid, g, 0).astype(jnp.int8)
    mq = (~valid).astype(jnp.int8)
    hq = jnp.where(valid, 2 * jnp.minimum(g, 1), 0).astype(jnp.int8)

    partial = jnp.stack([
        jnp.sum(valid, axis=1).astype(jnp.float32),       # n_valid
        jnp.sum(gq == 1, axis=1, dtype=jnp.float32),      # c1
        jnp.sum(gq == 2, axis=1, dtype=jnp.float32),      # c2
    ], axis=0)
    n_valid_raw, c1, c2 = lax.psum(partial, axis)

    pre = finish_preprocess_int8(n_valid_raw, c1, c2,
                                 jnp.float32(n_pad_total) - n_valid_raw,
                                 pos_ok, maf_thr, n_samples, n_pad_total)
    pre.update({"g": gq, "m": mq, "h": hq})
    return pre


def _sample_shard_fn(g, pos_ok, lo, hi, blk_lo, blk_hi, annot=None, *,
                     maf_thr, std_thr, rsq_thr, n_samples, n_pad_total,
                     block_size, band_k, m_pad, has_missing, dot_dtype,
                     packed=False):
    """Per-shard body: g is (M_pad, N_pad/d) int8 — or, with ``packed``,
    (M_pad, bytes_per_snp/d) raw 2-bit .bed bytes unpacked on the shard
    (4× less transfer); everything else replicated.

    ``annot``: optional f32 (M_pad, p) annotation matrix, REPLICATED —
    the annot contraction happens after the per-tile psum, so every shard
    computes identical (deterministic) partitioned credits."""
    B = block_size
    idot = make_idot(dot_dtype)
    n = jnp.float32(n_samples)
    n_padf = jnp.float32(n_pad_total)

    if packed:
        from ..ld.preprocess import unpack_bed  # noqa: PLC0415
        bps_local = g.shape[1]
        col0 = lax.axis_index(SNP_AXIS) * (4 * bps_local)
        g = unpack_bed(g, n_samples=n_samples, n_pad=4 * bps_local,
                       pad_val=-1, col0=col0)
    pre = shard_preprocess_int8(g, pos_ok, maf_thr, n_samples=n_samples,
                                n_pad_total=n_pad_total, axis=SNP_AXIS)
    gq, mq, hq = pre["g"], pre["m"], pre["h"]
    usable = pre["usable"]
    add_sd_zero = pre["add_sd_zero"]
    dom_ok = usable & (pre["rstd"] > jnp.float32(std_thr)) & ~add_sd_zero
    maf_out, rstd_out = pre["maf"], pre["rstd"]
    scal = stack_scalars(pre)

    # ---- banded pass: partial S tiles, psum per tile pair ----
    band_rows = min(band_k * B, m_pad)

    def pivot_block(b):
        r0 = b * B
        gi_rows = lax.dynamic_slice_in_dim(gq, r0, B, axis=0)
        mi_rows = lax.dynamic_slice_in_dim(mq, r0, B, axis=0)
        gi = r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo, r0, B)
        hi_i = lax.dynamic_slice_in_dim(hi, r0, B)
        usable_i = lax.dynamic_slice_in_dim(usable, r0, B)
        sc_i = scal_views(lax.dynamic_slice_in_dim(scal, r0, B, axis=0), "col")

        j0 = jnp.clip(blk_lo[b] * B, 0, m_pad - band_rows)
        gj_rows = lax.dynamic_slice_in_dim(gq, j0, band_rows, axis=0)
        mj_rows = lax.dynamic_slice_in_dim(mq, j0, band_rows, axis=0)
        hj_rows = lax.dynamic_slice_in_dim(hq, j0, band_rows, axis=0)
        gj = j0 + jnp.arange(band_rows, dtype=jnp.int32)
        usable_j = lax.dynamic_slice_in_dim(usable, j0, band_rows)
        dom_ok_j = lax.dynamic_slice_in_dim(dom_ok, j0, band_rows)
        poison_j = lax.dynamic_slice_in_dim(add_sd_zero, j0, band_rows)
        sc_j = scal_views(lax.dynamic_slice_in_dim(scal, j0, band_rows,
                                                   axis=0), "row")

        # shard-partial integer matmuls, combined exactly with psum
        names = ["sgg", "sgh"]
        tiles = [idot(gi_rows, gj_rows), idot(gi_rows, hj_rows)]
        if has_missing:
            names += ["sgm", "smg", "smm", "smh"]
            tiles += [idot(gi_rows, mj_rows), idot(mi_rows, gj_rows),
                      idot(mi_rows, mj_rows), idot(mi_rows, hj_rows)]
        tiles = lax.psum(jnp.stack(tiles), SNP_AXIS)
        dots = dict(zip(names, tiles))
        r_add, r_dom = corr_from_dots(dots, sc_i, sc_j, n, n_padf,
                                      has_missing)
        aj = (None if annot is None else
              lax.dynamic_slice_in_dim(annot, j0, band_rows, axis=0))
        return _tile_epilogue(r_add * n, r_dom * n, gi, gj, lo_i, hi_i,
                              usable_i, usable_j, dom_ok_j, poison_j,
                              n_samples, rsq_thr, aj=aj)

    accs = lax.map(pivot_block, jnp.arange(m_pad // B, dtype=jnp.int32))
    flat = tuple(a.reshape(m_pad) for a in accs[:6])
    if annot is not None:
        flat = flat + tuple(a.reshape(m_pad, -1) for a in accs[6:])
    return flat + (usable, add_sd_zero, maf_out, rstd_out)


@partial(jax.jit,
         static_argnames=("maf_thr", "std_thr", "rsq_thr", "n_samples",
                          "n_pad_total", "block_size", "band_k", "mesh",
                          "has_missing", "dot_dtype", "packed"))
def _sample_sharded_call(g, pos_ok, lo, hi, blk_lo, blk_hi, annot=None, *,
                         maf_thr, std_thr, rsq_thr, n_samples, n_pad_total,
                         block_size, band_k, mesh, has_missing, dot_dtype,
                         packed=False):
    fn = partial(_sample_shard_fn, maf_thr=maf_thr, std_thr=std_thr,
                 rsq_thr=jnp.float32(rsq_thr), n_samples=n_samples,
                 n_pad_total=n_pad_total, block_size=block_size,
                 band_k=band_k, m_pad=g.shape[0], has_missing=has_missing,
                 dot_dtype=dot_dtype, packed=packed)
    in_specs = (P(None, SNP_AXIS), P(), P(), P(), P(), P())
    args = (g, pos_ok, lo, hi, blk_lo, blk_hi)
    n_out = 10
    if annot is not None:
        in_specs = in_specs + (P(),)
        args = args + (annot,)
        n_out = 12
    out = jax.shard_map(
        fn, mesh=mesh,
        in_specs=in_specs,
        out_specs=tuple([P()] * n_out),
    )(*args)
    l2_acc, l2d_acc, ws, wsd, wse, poi = out[:6]
    usable, add_sd_zero, maf, rstd = out[-4:]
    fin = finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poi, usable,
                           add_sd_zero)
    if annot is None:
        return fin + (maf, rstd)
    from ..ld.ld_int8 import finalize_annot  # noqa: PLC0415
    l2_a, l2d_a = finalize_annot(out[6], out[7], annot, usable,
                                 add_sd_zero, poi, wsd)
    return fin + (maf, rstd, l2_a, l2d_a)


def _band_shard_fn_samples(raw_band, pos_ok_band, lo_piv, hi_piv, band_g0,
                           m_pad, rsq_thr, annot_b=None, *, packed,
                           maf_thr, std_thr, n_samples, n_pad_total,
                           block_size, right_k, n_piv_blocks, has_missing,
                           dot_dtype, axis):
    """Per-shard body of one streaming chunk with the SAMPLE axis sharded.

    ``raw_band``: this shard's sample columns of the chunk band — packed
    2-bit .bed bytes (band_rows, bytes_per_snp/d) unpacked on the shard,
    or int8 codes (band_rows, N_pad/d).  Per-SNP stats and every tile's
    S-matrices are psum'd, so outputs are replicated (deterministic).

    ``annot_b``: optional f32 (band_rows, p) band annotations,
    REPLICATED — contracted after the per-tile psums, so partitioned
    credits are identical on every shard.
    """
    from ..ld.preprocess import unpack_bed  # noqa: PLC0415
    from ..ld.streaming import _banded_chunk_int8_sym  # noqa: PLC0415

    if packed:
        bps_local = raw_band.shape[1]
        col0 = lax.axis_index(axis) * (4 * bps_local)
        g = unpack_bed(raw_band, n_samples=n_samples, n_pad=4 * bps_local,
                       pad_val=-1, col0=col0)
    else:
        g = raw_band          # host already padded cols ≥ n with −1
    pre = shard_preprocess_int8(g, pos_ok_band, jnp.float32(maf_thr),
                                n_samples=n_samples,
                                n_pad_total=n_pad_total, axis=axis)
    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(std_thr))
    accs = _banded_chunk_int8_sym(
        pre, dom_ok, lo_piv, hi_piv, band_g0, m_pad, rsq_thr, annot_b,
        block_size=block_size, right_k=right_k, n_samples=n_samples,
        n_piv_blocks=n_piv_blocks, has_missing=has_missing,
        dot_dtype=dot_dtype, psum_axis=axis, n_pad_total=n_pad_total)
    return accs + (pre["usable"], pre["add_sd_zero"], pre["maf"],
                   pre["rstd"])


@partial(jax.jit,
         static_argnames=("mesh", "packed", "maf_thr", "std_thr",
                          "n_samples", "n_pad_total", "block_size",
                          "right_k", "n_piv_blocks", "has_missing",
                          "dot_dtype"))
def sample_sharded_chunk_sym(raw_band, pos_ok_band, lo_piv, hi_piv, band_g0,
                             m_pad, rsq_thr, annot_b=None, *, mesh, packed,
                             maf_thr, std_thr, n_samples, n_pad_total,
                             block_size, right_k, n_piv_blocks,
                             has_missing, dot_dtype):
    """One symmetric streaming chunk with the SAMPLE axis over ``mesh``.

    The out-of-core × sample-sharded composition (2-D scale: M streamed
    from disk, N scattered over devices).  Same return contract as
    :func:`nldsc_jax.ld.streaming._banded_chunk_int8_sym` plus the
    replicated per-SNP stats the streaming collector needs:
    ``(local, tail, [local_a, tail_a,] usable, add_sd_zero, maf, rstd)``
    — the annot pair present when ``annot_b`` (replicated band
    annotations) is given.
    """
    axis = mesh.axis_names[0]
    fn = partial(_band_shard_fn_samples, packed=packed, maf_thr=maf_thr,
                 std_thr=std_thr, n_samples=n_samples,
                 n_pad_total=n_pad_total, block_size=block_size,
                 right_k=right_k, n_piv_blocks=n_piv_blocks,
                 has_missing=has_missing, dot_dtype=dot_dtype, axis=axis)
    in_specs = (P(None, axis), P(), P(), P(), P(), P(), P())
    args = (raw_band, pos_ok_band, lo_piv, hi_piv, band_g0, m_pad, rsq_thr)
    n_out = 6
    if annot_b is not None:
        in_specs = in_specs + (P(),)
        args = args + (annot_b,)
        n_out = 8
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=in_specs,
        out_specs=tuple([P()] * n_out),
    )(*args)


def ld_scores_sample_sharded(genotypes, positions: np.ndarray,
                             config, mesh,
                             annot: np.ndarray | None = None) -> dict:
    """In-core LD scores with the SAMPLE axis scattered over ``mesh``.

    ``genotypes``: int8 (M, N) codes — or a
    :class:`nldsc_jax.io.plink.PackedBed` of raw 2-bit rows, in which case
    each shard receives only ITS byte columns and unpacks on device (4×
    less host→device/ICI traffic — the packed-ingestion path).

    ``annot``: optional (M, p) annotation matrix (replicated; contracted
    after the per-tile psums, so partitioned credits are identical on
    every shard).  Extends the result with ``l2_annot``/``l2d_annot``.
    """
    from ..io.plink import PackedBed  # noqa: PLC0415
    from ..ld import windows  # noqa: PLC0415
    from ..ld.pipeline import to_host_result  # noqa: PLC0415

    packed = isinstance(genotypes, PackedBed)
    m, n = genotypes.shape
    B = config.block_size
    d = mesh.devices.size
    m_pad = -(-m // B) * B

    lo, hi, pos_ok = windows.window_bounds(positions, config.ld_wind)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, m_pad // B)
    lo_pad = np.concatenate([lo, np.full(m_pad - m, m_pad, np.int32)]).astype(np.int32)
    hi_pad = np.concatenate([hi, np.full(m_pad - m, -1, np.int32)]).astype(np.int32)
    pos_ok_pad = np.concatenate([pos_ok, np.zeros(m_pad - m, bool)])

    if packed:
        # byte columns split into 32-byte (128-sample) lanes per shard;
        # 0x55 padding = missing bitpairs, masked by the device unpack
        bps_pad = -(-genotypes.bytes_per_snp // (32 * d)) * (32 * d)
        n_pad = 4 * bps_pad
        g = np.full((m_pad, bps_pad), 0x55, dtype=np.uint8)
        g[:m, :genotypes.bytes_per_snp] = genotypes.raw
        has_missing = genotypes.has_missing
    else:
        col_chunk = 128 * d
        n_pad = -(-n // col_chunk) * col_chunk
        g = np.full((m_pad, n_pad), -1, dtype=np.int8)
        g[:m, :n] = genotypes
        has_missing = bool((genotypes < 0).any())

    a_dev = None
    if annot is not None:
        a_pad = np.zeros((m_pad, np.asarray(annot).shape[1]), np.float32)
        a_pad[:m] = np.asarray(annot, dtype=np.float32)
        a_dev = jnp.asarray(a_pad)

    with mesh:
        outs = _sample_sharded_call(
            jnp.asarray(g), jnp.asarray(pos_ok_pad), jnp.asarray(lo_pad),
            jnp.asarray(hi_pad), jnp.asarray(blk_lo), jnp.asarray(blk_hi),
            a_dev,
            maf_thr=float(config.maf_thr), std_thr=float(config.std_thr),
            rsq_thr=float(config.rsq_thr), n_samples=n, n_pad_total=n_pad,
            block_size=B, band_k=band_k, mesh=mesh,
            has_missing=has_missing, dot_dtype=config.int8_dot_dtype,
            packed=packed)

    l2, l2d, ws, wsd, wse, maf, rstd = outs[:7]
    result = to_host_result(l2, l2d, ws, wsd, wse, maf, rstd, m)
    if annot is not None:
        result["l2_annot"] = np.asarray(outs[7], dtype=np.float64)[:m]
        result["l2d_annot"] = np.asarray(outs[8], dtype=np.float64)[:m]
    return result
