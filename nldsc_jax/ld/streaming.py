"""Out-of-core (streaming) LD scores for datasets larger than device memory.

The reference handles big data by streaming one SNP at a time through a C++
sliding cache (``stream.h:106-198``).  The device equivalent is *chunked band
recompute*: pivot rows are processed in super-chunks of ``chunk_rows``; for
each chunk the engine

  1. block-decodes only the chunk's window band ``[band_lo, band_hi)`` of
     the .bed (a contiguous byte range — SNP-major layout),
  2. preprocesses the band on device (cheap vs the matmuls),
  3. runs the banded slab matmuls for the chunk's pivot blocks,
  4. streams the per-SNP outputs back to host.

Device memory is bounded by the band (≈ chunk_rows + 2·window_span rows of
f32), independent of total M.  Band overlap between consecutive chunks is
re-preprocessed — an O(window/chunk) overhead on the cheap stage only.

Each chunk is independent given its band, so the pass checkpoints at chunk
granularity: with ``resume_path`` set, completed chunks are persisted
(.npz) and skipped on restart — the checkpoint/resume behavior the
reference lacks entirely (SURVEY §5).
"""

from __future__ import annotations

import os
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..core.logging import log
from ..core.timing import STAGE_TIMES
from ..core.timing import stage_add as _stage_add
from .ld_xla import _tile_epilogue, finalize_outputs
from .preprocess import preprocess_block
from . import windows


@jax.jit
def _fold_split_deltas(l2_d, l2d_d, wse_d):
    """Stack split-corrections δ-vectors into the (6, rows) chunk credit
    layout (l2, ws, poison, l2d, wsd, wse; counters f32)."""
    z = jnp.zeros_like(l2_d)
    return jnp.stack([l2_d, z, z, l2d_d, z, wse_d.astype(jnp.float32)])


@partial(jax.jit, static_argnames=("block_size", "band_k", "n_samples",
                                   "n_piv_blocks", "has_missing",
                                   "dot_dtype"))
def _banded_chunk_int8(pre, dom_ok_b, lo_piv, hi_piv, blk_lo_piv, band_g0,
                       piv_off, m_pad, rsq_thr, annot_b=None, *,
                       block_size: int, band_k: int, n_samples: int,
                       n_piv_blocks: int, has_missing: bool, dot_dtype: str):
    """Integer-engine variant of :func:`_banded_chunk` (same geometry)."""
    from .ld_int8 import (corr_tiles, make_idot,  # noqa: PLC0415
                          scal_views, stack_scalars)

    B = block_size
    band_rows_total = pre["g"].shape[0]
    n_pad_cols = pre["g"].shape[1]
    slab_rows = min(band_k * B, band_rows_total)
    n = jnp.float32(n_samples)
    n_padf = jnp.float32(n_pad_cols)
    idot = make_idot(dot_dtype)
    usable_b = pre["usable"]
    poison_b = pre["add_sd_zero"]
    scal = stack_scalars(pre)

    def pivot_block(b):
        r0 = piv_off + b * B
        gi_rows = lax.dynamic_slice_in_dim(pre["g"], r0, B, axis=0)
        mi_rows = lax.dynamic_slice_in_dim(pre["m"], r0, B, axis=0)
        gi = band_g0 + r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo_piv, b * B, B)
        hi_i = lax.dynamic_slice_in_dim(hi_piv, b * B, B)
        usable_i = lax.dynamic_slice_in_dim(usable_b, r0, B)
        sc_i = scal_views(lax.dynamic_slice_in_dim(scal, r0, B, axis=0), "col")

        j0 = jnp.clip(blk_lo_piv[b] * B - band_g0, 0,
                      band_rows_total - slab_rows)
        gj_rows = lax.dynamic_slice_in_dim(pre["g"], j0, slab_rows, axis=0)
        mj_rows = lax.dynamic_slice_in_dim(pre["m"], j0, slab_rows, axis=0)
        hj_rows = lax.dynamic_slice_in_dim(pre["h"], j0, slab_rows, axis=0)
        gj = band_g0 + j0 + jnp.arange(slab_rows, dtype=jnp.int32)
        in_range = gj < m_pad
        usable_j = lax.dynamic_slice_in_dim(usable_b, j0, slab_rows) & in_range
        dom_ok_j = lax.dynamic_slice_in_dim(dom_ok_b, j0, slab_rows) & in_range
        poison_j = lax.dynamic_slice_in_dim(poison_b, j0, slab_rows) & in_range
        sc_j = scal_views(lax.dynamic_slice_in_dim(scal, j0, slab_rows,
                                                   axis=0), "row")

        r_add, r_dom = corr_tiles(
            idot, gi_rows, mi_rows, None, gj_rows, mj_rows, hj_rows,
            sc_i, sc_j, n, n_padf, has_missing)
        c_add = r_add * n  # _tile_epilogue divides by n itself
        c_dom = r_dom * n
        aj = (None if annot_b is None else
              lax.dynamic_slice_in_dim(annot_b, j0, slab_rows, axis=0))
        return _tile_epilogue(c_add, c_dom, gi, gj, lo_i, hi_i, usable_i,
                              usable_j, dom_ok_j, poison_j, n_samples,
                              rsq_thr, aj)

    return lax.map(pivot_block, jnp.arange(n_piv_blocks, dtype=jnp.int32))


@partial(jax.jit, static_argnames=("block_size", "right_k", "n_samples",
                                   "n_piv_blocks", "has_missing",
                                   "dot_dtype", "psum_axis", "n_pad_total"))
def _banded_chunk_int8_sym(pre, dom_ok_b, lo_piv, hi_piv, band_g0, m_pad,
                           rsq_thr, annot_b=None, *, block_size: int,
                           right_k: int, n_samples: int, n_piv_blocks: int,
                           has_missing: bool, dot_dtype: str,
                           psum_axis: str | None = None,
                           n_pad_total: int | None = None):
    """Symmetric integer chunk pass (right half-band only).

    The band holds ``[p0, p1 + halo)`` — pivots at local offset 0, right
    halo after them; each pair is computed once by the chunk owning its
    left member.  Returns (local (6, chunk_rows) row+col sums for the
    pivot rows, (6, halo) column credits for rows of LATER chunks).
    Quantity order: l2, ws, poison, l2d, wsd, wse (counters as f32 —
    exact below 2^24).

    ``annot_b``: optional f32 (band_rows, p) band-aligned annotations —
    extends the return with partitioned credits ((2, chunk_rows, p)
    local, (2, halo, p) tail; index 0 = L2, 1 = L2D), each pair weighted
    by its NEIGHBOR's annotation (ldscalc.h per-pair semantics).

    ``psum_axis``/``n_pad_total``: set when the SAMPLE axis is sharded
    over a mesh axis (``pre`` holds this shard's columns, its per-SNP
    scalars already psum'd-global); each tile's integer S-matrices are
    then psum'd before the epilogue, so every shard computes identical
    global outputs — the out-of-core × sample-sharded composition.
    """
    from .ld_int8 import (corr_tiles, make_idot,  # noqa: PLC0415
                          scal_views, stack_scalars)

    B = block_size
    chunk_rows = n_piv_blocks * B
    ext_rows = pre["g"].shape[0]
    halo = ext_rows - chunk_rows
    right_rows = min(right_k * B, ext_rows)
    n = jnp.float32(n_samples)
    n_pad_cols = (n_pad_total if n_pad_total is not None
                  else pre["g"].shape[1])
    n_padf = jnp.float32(n_pad_cols)
    inv_n2 = 1.0 / (n - 2.0)
    idot = make_idot(dot_dtype)

    usable_b = pre["usable"]
    poison_b = pre["add_sd_zero"]
    scal = stack_scalars(pre)

    def sl(v, at, size):
        return lax.dynamic_slice_in_dim(v, at, size)

    def step(carry, b):
        row_acc, col_acc = carry[:2]
        r0 = b * B
        gr0 = band_g0 + r0
        gi = gr0 + jnp.arange(B, dtype=jnp.int32)
        g_i = lax.dynamic_slice_in_dim(pre["g"], r0, B, axis=0)
        m_i = lax.dynamic_slice_in_dim(pre["m"], r0, B, axis=0)
        h_i = lax.dynamic_slice_in_dim(pre["h"], r0, B, axis=0)
        lo_i = sl(lo_piv, r0, B)[:, None]
        hi_i = sl(hi_piv, r0, B)[:, None]
        usable_i = sl(usable_b, r0, B)[:, None]
        poison_i = sl(poison_b, r0, B)[:, None]
        dom_ok_i = sl(dom_ok_b, r0, B)[:, None]
        sc_i = scal_views(lax.dynamic_slice_in_dim(scal, r0, B, axis=0), "col")

        j0 = jnp.minimum(r0, ext_rows - right_rows)
        gj = band_g0 + j0 + jnp.arange(right_rows, dtype=jnp.int32)
        g_j = lax.dynamic_slice_in_dim(pre["g"], j0, right_rows, axis=0)
        m_j = lax.dynamic_slice_in_dim(pre["m"], j0, right_rows, axis=0)
        h_j = lax.dynamic_slice_in_dim(pre["h"], j0, right_rows, axis=0)
        in_range = gj < m_pad
        usable_j = (sl(usable_b, j0, right_rows) & in_range)[None, :]
        poison_j = (sl(poison_b, j0, right_rows) & in_range)[None, :]
        dom_ok_j = (sl(dom_ok_b, j0, right_rows) & in_range)[None, :]
        sc_j = scal_views(lax.dynamic_slice_in_dim(scal, j0, right_rows,
                                                   axis=0), "row")

        r_add, r_domA, r_domB = corr_tiles(
            idot, g_i, m_i, h_i, g_j, m_j, h_j, sc_i, sc_j, n, n_padf,
            has_missing, symmetric=True, psum_axis=psum_axis)

        adj_add = r_add * r_add - (1.0 - r_add * r_add) * inv_n2
        adj_dA = r_domA * r_domA - (1.0 - r_domA * r_domA) * inv_n2
        adj_dB = r_domB * r_domB - (1.0 - r_domB * r_domB) * inv_n2

        in_win = (gj[None, :] >= lo_i) & (gj[None, :] <= hi_i)
        upair = in_win & usable_j & usable_i
        fwd = gj[None, :] >= gr0
        row_base = upair & fwd & (gj[None, :] != gi[:, None])
        col_base = upair & (gj[None, :] >= gr0 + B)
        dmA = row_base & dom_ok_j
        dmB = col_base & dom_ok_i

        rows_b = jnp.stack([
            jnp.sum(adj_add * row_base, axis=1),
            jnp.sum(row_base, axis=1).astype(jnp.float32),
            jnp.sum(upair & fwd & poison_j, axis=1).astype(jnp.float32),
            jnp.sum(adj_dA * dmA, axis=1),
            jnp.sum(dmA, axis=1).astype(jnp.float32),
            jnp.sum((adj_dA > rsq_thr) & dmA, axis=1).astype(jnp.float32),
        ])
        cols_b = jnp.stack([
            jnp.sum(adj_add * col_base, axis=0),
            jnp.sum(col_base, axis=0).astype(jnp.float32),
            jnp.sum(upair & poison_i & (gj[None, :] >= gr0 + B),
                    axis=0).astype(jnp.float32),
            jnp.sum(adj_dB * dmB, axis=0),
            jnp.sum(dmB, axis=0).astype(jnp.float32),
            jnp.sum((adj_dB > rsq_thr) & dmB, axis=0).astype(jnp.float32),
        ])
        row_acc = lax.dynamic_update_slice_in_dim(
            row_acc, lax.dynamic_slice_in_dim(row_acc, r0, B, axis=1) + rows_b,
            r0, axis=1)
        col_acc = lax.dynamic_update_slice_in_dim(
            col_acc, lax.dynamic_slice_in_dim(col_acc, j0, right_rows, axis=1)
            + cols_b, j0, axis=1)
        if annot_b is None:
            return (row_acc, col_acc), None

        # partitioned credits (precision highest: a lower precision
        # rounds the adjusted r² operand to bf16 or TF32)
        row_aa, col_aa = carry[2:]
        aj = lax.dynamic_slice_in_dim(annot_b, j0, right_rows, axis=0)
        ai = lax.dynamic_slice_in_dim(annot_b, r0, B, axis=0)
        dotp = partial(jnp.dot, precision="highest",
                       preferred_element_type=jnp.float32)
        rows_a = jnp.stack([dotp(adj_add * row_base, aj),
                            dotp(adj_dA * dmA, aj)])         # (2, B, p)
        cols_a = jnp.stack([dotp((adj_add * col_base).T, ai),
                            dotp((adj_dB * dmB).T, ai)])     # (2, rr, p)
        row_aa = lax.dynamic_update_slice_in_dim(
            row_aa, lax.dynamic_slice_in_dim(row_aa, r0, B, axis=1) + rows_a,
            r0, axis=1)
        col_aa = lax.dynamic_update_slice_in_dim(
            col_aa, lax.dynamic_slice_in_dim(col_aa, j0, right_rows, axis=1)
            + cols_a, j0, axis=1)
        return (row_acc, col_acc, row_aa, col_aa), None

    zr = jnp.zeros((6, chunk_rows), jnp.float32)
    zc = jnp.zeros((6, ext_rows), jnp.float32)
    init = (zr, zc)
    if annot_b is not None:
        p_a = annot_b.shape[1]
        init = init + (jnp.zeros((2, chunk_rows, p_a), jnp.float32),
                       jnp.zeros((2, ext_rows, p_a), jnp.float32))
    carry, _ = lax.scan(step, init,
                        jnp.arange(n_piv_blocks, dtype=jnp.int32))
    row_acc, col_acc = carry[:2]
    local = row_acc + col_acc[:, :chunk_rows]
    tail = col_acc[:, chunk_rows:] if halo > 0 else col_acc[:, :0]
    if annot_b is None:
        return local, tail
    row_aa, col_aa = carry[2:]
    local_a = row_aa + col_aa[:, :chunk_rows]
    tail_a = col_aa[:, chunk_rows:] if halo > 0 else col_aa[:, :0]
    return local, tail, local_a, tail_a


@partial(jax.jit, static_argnames=(
    "packed", "n_samples", "n_pad", "materialize_m", "block_size",
    "right_k", "n_piv_blocks", "has_missing", "dot_dtype", "use_split",
    "seg_rows", "n_segs", "p_band", "p_x"))
def _chunk_dispatch_sym(g_band, meta_dev, p0, m_pad, thresholds,
                        split_chunk=None, annot_full=None, *,
                        packed: bool, n_samples: int, n_pad: int,
                        materialize_m: bool, block_size: int, right_k: int,
                        n_piv_blocks: int, has_missing: bool,
                        dot_dtype: str, use_split: bool,
                        seg_rows: int = 0, n_segs: int = 0,
                        p_band: int = 0, p_x: int = 0):
    """ONE fused device program per streaming chunk (symmetric route).

    Everything between the band transfer and the result fetch — device
    unpack, integer preprocessing, the symmetric chunk pass, the split
    δ-corrections and the result packing — compiles into a single
    dispatch: each runtime call has a fixed host cost, and ~10-15 eager
    ops per chunk (dom_ok masks, split folds, separate stat fetches,
    eager finalize) would each pay it.  This leaves 3 runtime calls per
    chunk (band transfer, this dispatch, one payload fetch).

    ``meta_dev``: (pos_ok_ext, lo_ext, hi_ext) FULL-length device-resident
    metadata staged once before the chunk loop and sliced at ``p0``
    in-program (pos_ok_ext is padded to m_ext + halo).
    ``thresholds``: (maf_thr, std_thr, rsq_thr) f32 scalars.
    ``split_chunk``: per-chunk split tensors
    (miss_idx, lo_band, hi_band, rowmiss, cs, c_cnt, xs, x_cnt) or None.
    ``annot_full``: (m_ext + halo, p) device annotations or None.

    Returns a (6, 2·chunk_rows + halo) f32 payload —
    ``[local | tail | stats]`` with stats rows (usable, poison, maf,
    rstd, 0, 0) — plus, for annot runs, a (2, chunk_rows + halo, p)
    annot payload ``[local_a | tail_a]``.  One host fetch each; the
    NaN/-1 sentinel finalization happens on host in f32
    (:func:`_finalize_np`, bitwise-identical IEEE ops).
    """
    from .ld_int8 import preprocess_int8, stack_scalars  # noqa: PLC0415
    from .preprocess import unpack_bed  # noqa: PLC0415

    chunk_rows = n_piv_blocks * block_size
    pos_ok_ext, lo_ext, hi_ext = meta_dev
    maf_thr, std_thr, rsq_thr = thresholds

    g = (unpack_bed(g_band, n_samples=n_samples, n_pad=n_pad, pad_val=-1)
         if packed else g_band)
    band_rows = g.shape[0]
    pos_ok_band = lax.dynamic_slice_in_dim(pos_ok_ext, p0, band_rows)
    lo_c = lax.dynamic_slice_in_dim(lo_ext, p0, chunk_rows)
    hi_c = lax.dynamic_slice_in_dim(hi_ext, p0, chunk_rows)

    pre = preprocess_int8(g, pos_ok_band, maf_thr, n_samples=n_samples,
                          materialize_m=materialize_m)
    dom_ok = pre["usable"] & (pre["rstd"] > std_thr)
    annot_b = (None if annot_full is None else
               lax.dynamic_slice_in_dim(annot_full, p0, band_rows, axis=0))
    accs = _banded_chunk_int8_sym(
        pre, dom_ok, lo_c, hi_c, p0, m_pad, rsq_thr, annot_b,
        block_size=block_size, right_k=right_k, n_samples=n_samples,
        n_piv_blocks=n_piv_blocks,
        has_missing=(False if use_split else has_missing),
        dot_dtype=dot_dtype)
    local, tail = accs[:2]
    local_a = tail_a = None
    if annot_full is not None:
        local_a, tail_a = accs[2], accs[3]
    if use_split:
        from .ld_split import (  # noqa: PLC0415
            compact_missing_rows, split_corrections)

        miss_idx, lo_b, hi_b, rowmiss, cs, c_cnt, xs, x_cnt = split_chunk
        sc_out = split_corrections(
            pre["g"], compact_missing_rows(g, miss_idx), pre["h"],
            stack_scalars(pre), lo_b, hi_b, pre["usable"], dom_ok,
            rowmiss, rsq_thr, jnp.int32(chunk_rows), miss_idx, cs, c_cnt,
            xs, x_cnt, annot_b, seg_rows=seg_rows, n_segs=n_segs,
            p_band=p_band, p_x=p_x, n_samples=n_samples,
            dot_dtype=dot_dtype)
        delta = _fold_split_deltas(*sc_out[:3])
        local = local + delta[:, :chunk_rows]
        tail = tail + delta[:, chunk_rows:]
        if annot_full is not None:
            da = jnp.stack(sc_out[3:])           # (2, band_rows, p)
            local_a = local_a + da[:, :chunk_rows]
            tail_a = tail_a + da[:, chunk_rows:]

    zeros = jnp.zeros(chunk_rows, jnp.float32)
    stats = jnp.stack([
        pre["usable"][:chunk_rows].astype(jnp.float32),
        pre["add_sd_zero"][:chunk_rows].astype(jnp.float32),
        pre["maf"][:chunk_rows], pre["rstd"][:chunk_rows], zeros, zeros])
    payload = jnp.concatenate([local, tail, stats], axis=1)
    if annot_full is None:
        return payload
    return payload, jnp.concatenate([local_a, tail_a], axis=1)


def _finalize_np(l2_acc, l2d_acc, ws, wsd, wse, poison, usable, add_sd_zero):
    """Host-side float32 mirror of ``ld_xla.finalize_outputs`` — the same
    IEEE f32 ops in the same order, so results are bitwise identical
    without spending device round-trips on sentinel masking."""
    l2a = l2_acc.astype(np.float32)
    l2da = l2d_acc.astype(np.float32)
    nan = np.float32(np.nan)
    l2 = np.where(usable & (poison == 0), np.float32(1.0) + l2a, nan)
    l2d_bad = np.where(wsd > 0, nan, np.float32(0.0))
    l2d = np.where(usable, np.where(add_sd_zero, l2d_bad, l2da), nan)
    ws_o = np.where(usable, ws, -1).astype(np.int32)
    wsd_o = np.where(usable, wsd, -1).astype(np.int32)
    wse_o = np.where(usable, np.where(add_sd_zero, 0, wse), -1).astype(np.int32)
    return l2, l2d, ws_o, wsd_o, wse_o


@partial(jax.jit, static_argnames=("block_size", "band_k", "n_samples",
                                   "n_piv_blocks"))
def _banded_chunk(add_b, res_b, usable_b, dom_ok_b, poison_b,
                  lo_piv, hi_piv, blk_lo_piv, band_g0, piv_off, m_pad,
                  rsq_thr, annot_b=None, *, block_size: int, band_k: int,
                  n_samples: int, n_piv_blocks: int):
    """Banded slab pass for one pivot chunk against its loaded band.

    add_b/res_b: (band_rows, n_pad) preprocessed band; *_b masks (band_rows,).
    lo_piv/hi_piv: global window bounds of the chunk's pivot rows.
    blk_lo_piv: global first-neighbor-block per pivot block (n_piv_blocks,).
    band_g0: global row of band start; piv_off: local offset of pivot rows.
    """
    B = block_size
    band_rows_total = add_b.shape[0]
    slab_rows = min(band_k * B, band_rows_total)

    def pivot_block(b):
        r0 = piv_off + b * B
        ya = lax.dynamic_slice_in_dim(add_b, r0, B, axis=0)
        gi = band_g0 + r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo_piv, b * B, B)
        hi_i = lax.dynamic_slice_in_dim(hi_piv, b * B, B)
        usable_i = lax.dynamic_slice_in_dim(usable_b, r0, B)

        j0 = jnp.clip(blk_lo_piv[b] * B - band_g0, 0,
                      band_rows_total - slab_rows)
        za = lax.dynamic_slice_in_dim(add_b, j0, slab_rows, axis=0)
        zr = lax.dynamic_slice_in_dim(res_b, j0, slab_rows, axis=0)
        gj = band_g0 + j0 + jnp.arange(slab_rows, dtype=jnp.int32)
        in_range = gj < m_pad
        usable_j = lax.dynamic_slice_in_dim(usable_b, j0, slab_rows) & in_range
        dom_ok_j = lax.dynamic_slice_in_dim(dom_ok_b, j0, slab_rows) & in_range
        poison_j = lax.dynamic_slice_in_dim(poison_b, j0, slab_rows) & in_range

        c_add = jnp.dot(ya, za.T, precision="highest",
                        preferred_element_type=jnp.float32)
        c_dom = jnp.dot(ya, zr.T, precision="highest",
                        preferred_element_type=jnp.float32)
        aj = (None if annot_b is None else
              lax.dynamic_slice_in_dim(annot_b, j0, slab_rows, axis=0))
        return _tile_epilogue(c_add, c_dom, gi, gj, lo_i, hi_i, usable_i,
                              usable_j, dom_ok_j, poison_j, n_samples,
                              rsq_thr, aj)

    return lax.map(pivot_block, jnp.arange(n_piv_blocks, dtype=jnp.int32))


def compute_ld_scores_streaming(bed, positions: np.ndarray, config, *,
                                chunk_rows: int = 8192,
                                resume_path: str | None = None,
                                devices=None, annot=None,
                                sample_mesh=None, grid=None) -> dict:
    """Streamed LD scores from a :class:`BedReader` (out-of-core in M).

    Same result contract as ``pipeline.compute_ld_scores``.  ``chunk_rows``
    bounds device memory: the band held on device is at most
    ``chunk_rows + 2*window_span`` rows (f32, both encodings).

    ``annot``: optional (M, p) float annotation matrix — computes
    PARTITIONED LD scores out-of-core (adds ``l2_annot``/``l2d_annot`` to
    the result).  Streaming annot runs the SYMMETRIC chunk pass (commit
    eee6f34; unlike the in-core default): out-of-core the band transfer
    dominates and the symmetric right-only band ships ~2/3 the bytes, so
    the annot credits mirror through the same per-direction contractions
    as the chunk pass (``_banded_chunk_int8_sym`` annot epilogue).
    Composes with ``devices``
    round-robin, with the split-missing corrections (annot δ-credits
    fold into the chunk's annot payload, r4), and with
    ``sample_mesh``/``grid`` (replicated band annotations contracted
    after the per-tile psums).

    ``devices``: optional list of JAX devices — chunks are dispatched
    round-robin across them (each chunk's band is self-contained, so no
    inter-device halo traffic is needed: the combination of the sharded
    and streaming engines).  Dispatch is async; results are collected one
    full rotation behind, so up to ``len(devices)`` chunks are in flight.

    ``sample_mesh``: optional 1-D mesh — shard the SAMPLE axis of every
    chunk band over it instead (the 2-D composition: M streamed from
    disk, N scattered over devices, tile S-matrices psum'd).  The right
    scale-out when one chromosome's band row (N samples) dominates device
    memory or compute — each device holds/contracts only N/d samples.
    Mutually exclusive with ``devices``; integer symmetric engine only.

    ``grid``: optional 2-D ``Mesh`` of shape (snp_groups, samp_shards) —
    the full out-of-core 3-axis scale: M streamed from disk, chunks
    round-robined over the ``snp_groups`` mesh rows (each row a
    self-contained sample submesh, up to ``snp_groups`` chunks in
    flight), and each chunk's SAMPLE axis scattered over its row with
    exact integer psums.  Mutually exclusive with ``devices`` and
    ``sample_mesh``; integer symmetric engine only.  Each row submesh
    compiles its own executable (identical program, different device
    group) — ``snp_groups`` compiles total.
    """
    t_enter = time.time()
    m, n = bed.n_snp, bed.n_samples
    B = config.block_size
    chunk_rows = max(B, (chunk_rows // B) * B)
    m_pad = -(-m // B) * B
    if grid is not None:
        if sample_mesh is not None or devices:
            raise ValueError("grid is mutually exclusive with sample_mesh "
                             "and devices")
        from jax.sharding import Mesh  # noqa: PLC0415

        d_samp = grid.devices.shape[1]
        samp_axis = grid.axis_names[1]
        samp_meshes = [Mesh(grid.devices[i], (samp_axis,))
                       for i in range(grid.devices.shape[0])]
    else:
        d_samp = sample_mesh.devices.size if sample_mesh is not None else 1
        samp_meshes = [sample_mesh] if sample_mesh is not None else None
    n_pad = -(-n // (128 * d_samp)) * (128 * d_samp)

    lo, hi, pos_ok = windows.window_bounds(positions, config.ld_wind)
    blk_lo_all, blk_hi_all, band_k = windows.band_blocks(lo, hi, B, m_pad // B)
    right_k = windows.right_band_blocks(blk_hi_all, B)
    halo = -(-windows.max_halo_rows(lo, hi) // B) * B

    use_int8 = config.use_int8 if config.use_int8 is not None else True
    # symmetric streaming: each pair computed once by the chunk owning its
    # LEFT member — the band shrinks to [p0, p1 + halo) (right-only, ~2/3
    # the decode+transfer) and matmuls drop to 3/8 half-band products;
    # column credits for later chunks ride a host-side carry (checkpointed
    # in the shard files as `tail`)
    symmetric = ((config.symmetric if config.symmetric is not None else True)
                 and use_int8)
    if samp_meshes is not None:
        if sample_mesh is not None and devices:
            raise ValueError("sample_mesh and devices are mutually "
                             "exclusive — the mesh already uses its devices")
        which = "grid-sharded" if grid is not None else "sample-sharded"
        if not symmetric:
            raise ValueError(f"{which} streaming requires the "
                             "symmetric integer engine (use_int8, "
                             "symmetric not disabled)")

    # fixed shapes across chunks -> one trace: pivot span always chunk_rows;
    # edges handled by masking
    n_chunks = -(-m_pad // chunk_rows)
    m_ext = n_chunks * chunk_rows
    band_rows = chunk_rows + (1 if symmetric else 2) * halo
    lead = 0 if symmetric else halo   # rows of band before the pivots
    use_packed = hasattr(bed, "read_raw")

    def pad_meta(a, fill):
        return np.concatenate(
            [a, np.full(m_ext - len(a), fill, a.dtype)]).astype(a.dtype)

    lo_pad = pad_meta(lo.astype(np.int32), np.int32(m_pad))
    hi_pad = pad_meta(hi.astype(np.int32), np.int32(-1))
    pos_ok_pad = pad_meta(pos_ok, False)
    nbk = len(blk_lo_all)
    blk_lo_pad = np.concatenate(
        [blk_lo_all, np.arange(nbk, m_ext // B, dtype=np.int32)])

    # --- split-missing selection (same policy as the in-core pipeline):
    # one LUT pass over the .bed bytes finds which rows actually carry
    # missing genotypes; when they are a minority, every chunk runs the
    # clean 3-matmul pass + compact exact corrections instead of the
    # global 8-matmul epilogue
    split_plans = None
    split_p = split_px = 0
    rowmiss_all = None
    from .ld_split import SEG_ROWS_DEFAULT  # noqa: PLC0415
    split_seg = min(SEG_ROWS_DEFAULT, band_rows)
    split_nseg = -(-band_rows // split_seg)
    if (symmetric and samp_meshes is None and use_packed
            and config.split_missing is not False):
        from ..io.plink import scan_rowmiss  # noqa: PLC0415
        from .ld_split import plan_split_v2  # noqa: PLC0415

        # the scan re-reads the ENTIRE .bed (most of a biobank-scale
        # run's set-up); with a checkpoint dir the bitmap is
        # cached (keyed by the .bed identity the meta also pins), so a
        # resumed run skips straight to the chunks it actually needs
        rowmiss_all = None
        rm_cache = None
        if resume_path:
            from pathlib import Path  # noqa: PLC0415

            rm_cache = Path(resume_path) / "rowmiss.npz"
            if rm_cache.exists():
                d = np.load(rm_cache, allow_pickle=False)
                if (str(d["bed_path"]) == os.path.abspath(bed.path)
                        and int(d["bed_bytes"]) == os.path.getsize(bed.path)
                        and d["rowmiss"].shape[0] == m):
                    rowmiss_all = d["rowmiss"]
        if rowmiss_all is None:
            rowmiss_all = scan_rowmiss(bed)
            if rm_cache is not None:
                rm_cache.parent.mkdir(parents=True, exist_ok=True)
                tmp = rm_cache.with_name(".tmp_rowmiss.npz")
                np.savez(tmp, rowmiss=rowmiss_all,
                         bed_path=os.path.abspath(bed.path),
                         bed_bytes=os.path.getsize(bed.path))
                os.replace(tmp, rm_cache)
        frac = float(rowmiss_all.mean())
        want = (config.split_missing if config.split_missing is not None
                else 0.0 < frac <= 0.25)
        if want and rowmiss_all.any():
            # the v2 segmented corrections run per chunk on the BAND in
            # LOCAL coordinates with own_hi = chunk_rows (pair owned by
            # the chunk holding its left member — the chunk pass's own
            # ownership rule), so every global pair is corrected once
            rm_pad = np.zeros(m_ext + halo, dtype=bool)
            rm_pad[:m] = rowmiss_all
            lo_ext = np.concatenate(
                [lo_pad, np.full(halo, m_pad, np.int32)]).astype(np.int32)
            hi_ext = np.concatenate(
                [hi_pad, np.full(halo, -1, np.int32)]).astype(np.int32)
            raw_plans = []
            for ci in range(n_chunks):
                r0c = ci * chunk_rows
                rb = rm_pad[r0c:r0c + band_rows]
                lo_loc = lo_ext[r0c:r0c + band_rows] - r0c
                hi_loc = hi_ext[r0c:r0c + band_rows] - r0c
                raw_plans.append(
                    (rb, plan_split_v2(rb, lo_loc, hi_loc, split_seg,
                                       band_rows)))
            # one compile across chunks: pad every plan to the run maxima
            split_p = max(p["p_band"] for _, p in raw_plans)
            split_px = max(p["p_x"] for _, p in raw_plans)
            mm = max(p["n_miss"] for _, p in raw_plans) + max(split_p,
                                                              split_px)
            split_plans = []
            for rb, p in raw_plans:
                mi = np.full(mm, band_rows - 1, dtype=np.int32)
                mi[: p["n_miss"]] = p["miss_idx"][: p["n_miss"]]
                r0c = len(split_plans) * chunk_rows
                split_plans.append({"rowmiss": rb, "miss_idx": mi,
                                    "cs": p["cs"], "c_cnt": p["c_cnt"],
                                    "xs": p["xs"], "x_cnt": p["x_cnt"],
                                    "lo": lo_ext[r0c:r0c + band_rows] - r0c,
                                    "hi": hi_ext[r0c:r0c + band_rows] - r0c,
                                    "has_any": bool(rb.any())})
            log.info("Split-missing streaming engine: %.2f%% contaminated "
                     "rows (P=%d, Px=%d, %d band segments)", 100.0 * frac,
                     split_p, split_px, split_nseg)


    out = {k: np.full(m_ext, np.nan) for k in ("l2", "l2d", "maf",
                                               "residuals_std")}
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        out[k] = np.full(m_ext, -1, dtype=np.int64)
    annot_pad = None
    if annot is not None:
        p_annot = annot.shape[1]
        annot_pad = np.zeros((m_ext, p_annot), dtype=np.float32)
        annot_pad[:m] = np.asarray(annot, dtype=np.float32)
        out["l2_annot"] = np.full((m_ext, p_annot), np.nan)
        out["l2d_annot"] = np.full((m_ext, p_annot), np.nan)

    # checkpoint = a DIRECTORY of per-chunk shard files: each completed
    # chunk is written exactly once (atomic tmp+rename), so total
    # checkpoint IO is O(M) regardless of chunk count, and a crashed run
    # loses at most the in-flight chunk
    done = set()
    ck_dir = None
    # host-side carry of column credits for rows of later chunks
    # (symmetric mode only); aligned at the next uncollected chunk's p0
    carry = np.zeros((6, halo), dtype=np.float64)
    carry_a = (np.zeros((2, halo, annot.shape[1]), dtype=np.float64)
               if annot is not None else None)
    if resume_path:
        import json  # noqa: PLC0415
        from pathlib import Path  # noqa: PLC0415

        ck_dir = Path(resume_path)
        ck_dir.mkdir(parents=True, exist_ok=True)
        # the meta must pin EVERYTHING that changes per-chunk results:
        # geometry, every filter threshold, the window metric, the engine
        # numerics, and the input .bed identity (path + size — a cheap
        # content fingerprint without hashing GBs).  Resuming with any
        # mismatch would silently splice inconsistent chunks into one .L2.
        meta = {"m": m, "n": n, "chunk_rows": chunk_rows, "block_size": B,
                "ld_wind": float(config.ld_wind),
                "wind_metric": config.wind_metric,
                "maf_thr": float(config.maf_thr),
                "std_thr": float(config.std_thr),
                "rsq_thr": float(config.rsq_thr),
                "engine": ("sym-split2" if split_plans is not None
                           else "sym" if symmetric else "full"),
                "annot_p": -1 if annot is None else annot.shape[1],
                "dot_dtype": config.int8_dot_dtype if use_int8 else "f32",
                "bed_path": os.path.abspath(getattr(bed, "path", "")),
                "bed_bytes": (os.path.getsize(bed.path)
                              if getattr(bed, "path", None) else 0)}
        meta_path = ck_dir / "meta.json"
        if meta_path.exists():
            saved_meta = json.loads(meta_path.read_text())
            diff = {k: (saved_meta.get(k), v) for k, v in meta.items()
                    if saved_meta.get(k) != v}
            if diff:
                raise ValueError(
                    f"checkpoint {ck_dir} was written with different "
                    f"parameters — refusing to resume (mismatched: {diff}); "
                    "use a fresh checkpoint directory")
        else:
            meta_path.write_text(json.dumps(meta))
        shards = {}
        for f in sorted(ck_dir.glob("chunk_*.npz")):
            shards[int(f.stem.split("_")[1])] = f
        if symmetric:
            # credits flow forward, so only a CONTIGUOUS prefix of
            # completed chunks is resumable; later orphans recompute
            k = 0
            while k in shards:
                k += 1
            shards = {ci: f for ci, f in shards.items() if ci < k}
        for ci, f in shards.items():
            saved = np.load(f)
            c0, c1 = ci * chunk_rows, (ci + 1) * chunk_rows
            for k_ in out:
                out[k_][c0:c1] = saved[k_]
            done.add(ci)
            if symmetric and "tail" in saved:
                # fold this chunk's stored credits into the carry aligned
                # at the resume point p0 = len(shards)*chunk_rows
                offset = (len(shards) - 1 - ci) * chunk_rows
                if offset < halo:
                    carry[:, :halo - offset] += saved["tail"][:, offset:]
                    if carry_a is not None and "tail_a" in saved:
                        carry_a[:, :halo - offset] += \
                            saved["tail_a"][:, offset:]
        if done:
            log.info("Resuming: %d chunks already complete", len(done))

    # packed (2-bit) band ingestion: ship raw .bed bytes and unpack on
    # device — 4× less host→device transfer than int8 codes, and the
    # band transfer is the streaming engine's main non-compute cost
    # sample sharding needs the byte columns to split evenly into
    # 128-sample (32-byte) lanes per shard; padding bytes are 0x55
    # (missing bitpairs) and the device unpack masks them anyway
    bps_pad = (-(-bed.bytes_per_snp // (32 * d_samp)) * (32 * d_samp)
               if (use_packed and samp_meshes is not None)
               else (bed.bytes_per_snp if use_packed else 0))

    def read_band(ci, tail_only=False):
        """Host-side read of chunk ci's window band (prefetch thread).

        ``tail_only`` (band-tail RETENTION, r5): consecutive symmetric
        bands overlap by exactly ``halo`` rows (band ci's last halo rows
        == band ci+1's first halo rows, padding included), so when the
        previous chunk's PACKED band is still resident on the device,
        only the ``chunk_rows`` NEW rows are read + transferred and the
        device band is assembled by concatenation in ``dispatch`` —
        cutting steady-state host→device traffic to exactly one
        chunk_rows of packed bytes per chunk (the overlap re-transfer
        was ~halo/band of every chunk).  Bytes are identical by
        construction, so outputs cannot move a bit.
        """
        p0 = ci * chunk_rows
        band_lo = p0 - lead              # may be negative (masked)
        band_hi = band_lo + band_rows
        chunk_has_missing = False
        if tail_only:
            # rows [band_lo + (band_rows - chunk_rows), band_hi) — the
            # part of this band the previous band does not cover
            t_lo = band_hi - chunk_rows
            r0, r1 = max(t_lo, 0), min(band_hi, m)
            g_band = np.full((chunk_rows, bps_pad), 0x55, dtype=np.uint8)
            if r1 > r0:
                packed = bed.read_raw(r0, r1 - r0)
                g_band[r0 - t_lo:r1 - t_lo,
                       :bed.bytes_per_snp] = packed.raw
            # band-level missing state from the up-front rowmiss scan
            # (identical semantics to read_raw's has_missing pass)
            b0, b1 = max(band_lo, 0), min(band_hi, m)
            chunk_has_missing = bool(rowmiss_all[b0:b1].any())
        elif use_packed:
            g_band = np.full((band_rows, bps_pad), 0x55, dtype=np.uint8)
            r0, r1 = max(band_lo, 0), min(band_hi, m)
            if r1 > r0:
                packed = bed.read_raw(r0, r1 - r0)
                chunk_has_missing = packed.has_missing
                g_band[r0 - band_lo:r1 - band_lo,
                       :bed.bytes_per_snp] = packed.raw
        else:
            g_band = np.full((band_rows, n_pad), -1, dtype=np.int8)
            r0, r1 = max(band_lo, 0), min(band_hi, m)
            if r1 > r0:
                block = bed.read_block(r0, r1 - r0)
                chunk_has_missing = bool((block < 0).any())
                g_band[r0 - band_lo:r1 - band_lo, :n] = block
        pos_ok_band = np.zeros(band_rows, dtype=bool)
        g0c, g1c = max(band_lo, 0), min(band_hi, m_ext)
        if g1c > g0c:
            pos_ok_band[g0c - band_lo:g1c - band_lo] = pos_ok_pad[g0c:g1c]
        return g_band, pos_ok_band, chunk_has_missing, tail_only

    from collections import deque  # noqa: PLC0415
    from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

    # the dispatch ring: one slot per independent device resource —
    # plain devices (round-robin chunks), ONE sample mesh (all devices
    # cooperate on every chunk), or the grid's row submeshes (chunks
    # round-robin over rows, each row sample-shards its chunk)
    ring = samp_meshes if samp_meshes is not None else (devices or [None])
    n_dev = len(ring)
    n_piv_blocks = chunk_rows // B

    # fused-dispatch staging (symmetric in-core route): full-run metadata
    # and thresholds live on each ring device ONCE; the per-chunk program
    # (_chunk_dispatch_sym) slices them at p0, so each chunk costs
    # exactly one band transfer + one dispatch + one payload fetch
    sym_fast = symmetric and samp_meshes is None
    if sym_fast:
        pos_ok_ext_h = np.zeros(m_ext + halo, dtype=bool)
        pos_ok_ext_h[:m_ext] = pos_ok_pad
        annot_full_h = None
        if annot_pad is not None:
            annot_full_h = np.zeros((m_ext + halo, annot_pad.shape[1]),
                                    np.float32)
            annot_full_h[:m_ext] = annot_pad
        meta_by_dev, annot_by_dev, thr_by_dev = {}, {}, {}
        for dv in ring:
            def put(x, dv=dv):
                return jax.device_put(x, dv) if dv is not None else jnp.asarray(x)
            meta_by_dev[dv] = (put(pos_ok_ext_h), put(lo_pad.copy()),
                               put(hi_pad.copy()))
            if annot_full_h is not None:
                annot_by_dev[dv] = put(annot_full_h)
            thr_by_dev[dv] = (put(np.float32(config.maf_thr)),
                              put(np.float32(config.std_thr)),
                              put(np.float32(config.rsq_thr)))

    # band-tail retention (see read_band): single-device symmetric
    # packed route only — round-robin rings place consecutive chunks on
    # different devices, where the previous band is not local
    retain = (sym_fast and n_dev == 1 and use_packed
              and rowmiss_all is not None)
    ret_state = {"ci": None, "band": None}

    def dispatch(ci, band, dev):
        """Queue chunk ci's device work (async); returns device arrays."""
        g_band, pos_ok_band, chunk_has_missing, tail_only = band
        p0 = ci * chunk_rows
        p1 = p0 + chunk_rows
        band_lo = p0 - lead

        def dev_put(x):
            a = jnp.asarray(x)
            return jax.device_put(a, dev) if dev is not None else a

        # transferred-bytes accounting (MB; rides the STAGE_TIMES dict —
        # the CLI stage log / PERFORMANCE read it, e.g. to verify the
        # band-retention transfer saving)
        STAGE_TIMES["stream_put_mb"] = (
            STAGE_TIMES.get("stream_put_mb", 0.0) + g_band.nbytes / 1e6)

        def band_dev():
            gb = dev_put(g_band)
            if use_packed:
                from .preprocess import unpack_bed  # noqa: PLC0415
                return unpack_bed(gb, n_samples=n, n_pad=n_pad, pad_val=-1)
            return gb

        if samp_meshes is not None:
            from jax.sharding import NamedSharding  # noqa: PLC0415
            from jax.sharding import PartitionSpec as P  # noqa: PLC0415

            from ..parallel.sample_sharded import (  # noqa: PLC0415
                sample_sharded_chunk_sym)

            mesh_c = dev                # this chunk's sample (sub)mesh
            cols = NamedSharding(mesh_c,
                                 P(None, mesh_c.axis_names[0]))
            raw_dev = jax.device_put(g_band, cols)
            annot_b = None
            if annot_pad is not None:
                ab = np.zeros((band_rows, annot_pad.shape[1]), np.float32)
                a0, a1 = max(band_lo, 0), min(band_lo + band_rows, m_ext)
                if a1 > a0:
                    ab[a0 - band_lo:a1 - band_lo] = annot_pad[a0:a1]
                annot_b = jax.device_put(ab, NamedSharding(mesh_c, P()))
            outs = sample_sharded_chunk_sym(
                raw_dev, jnp.asarray(pos_ok_band),
                jnp.asarray(lo_pad[p0:p1]), jnp.asarray(hi_pad[p0:p1]),
                jnp.int32(p0), jnp.int32(m_pad),
                jnp.float32(config.rsq_thr), annot_b, mesh=mesh_c,
                packed=use_packed, maf_thr=float(config.maf_thr),
                std_thr=float(config.std_thr), n_samples=n,
                n_pad_total=n_pad, block_size=B, right_k=right_k,
                n_piv_blocks=n_piv_blocks,
                has_missing=chunk_has_missing,
                dot_dtype=config.int8_dot_dtype)
            accs = outs[:-4]            # (local, tail[, local_a, tail_a])
            usable, add_sd_zero, maf, rstd = outs[-4:]
            pre = {"usable": usable, "add_sd_zero": add_sd_zero,
                   "maf": maf, "rstd": rstd}
            return pre, accs

        if sym_fast:
            use_split_c = (split_plans is not None
                           and split_plans[ci]["has_any"])
            split_dev_c = None
            split_kw = {}
            if use_split_c:
                pl = split_plans[ci]
                split_dev_c = tuple(
                    dev_put(pl[k]) for k in ("miss_idx", "lo", "hi",
                                             "rowmiss", "cs", "c_cnt",
                                             "xs", "x_cnt"))
                split_kw = dict(seg_rows=split_seg, n_segs=split_nseg,
                                p_band=split_p, p_x=split_px)
            if tail_only:
                if ret_state["ci"] != ci - 1:
                    raise RuntimeError(
                        f"band-tail retention out of order: retained band "
                        f"of chunk {ret_state['ci']}, expected {ci - 1}")
                g_band_dev = jnp.concatenate(
                    [ret_state["band"][chunk_rows:], dev_put(g_band)],
                    axis=0)
            else:
                g_band_dev = dev_put(g_band)
            if retain:
                ret_state["ci"], ret_state["band"] = ci, g_band_dev
            out_p = _chunk_dispatch_sym(
                g_band_dev, meta_by_dev[dev], np.int32(p0),
                np.int32(m_pad), thr_by_dev[dev], split_dev_c,
                annot_by_dev.get(dev),
                packed=use_packed, n_samples=n, n_pad=n_pad,
                materialize_m=(split_plans is None and chunk_has_missing),
                block_size=B, right_k=right_k, n_piv_blocks=n_piv_blocks,
                has_missing=(False if split_plans is not None
                             else chunk_has_missing),
                dot_dtype=config.int8_dot_dtype, use_split=use_split_c,
                **split_kw)
            return "payload", out_p

        annot_b = None
        if annot_pad is not None:
            ab = np.zeros((band_rows, annot_pad.shape[1]), np.float32)
            a0, a1 = max(band_lo, 0), min(band_lo + band_rows, m_ext)
            if a1 > a0:
                ab[a0 - band_lo:a1 - band_lo] = annot_pad[a0:a1]
            annot_b = dev_put(ab)

        chunk_args = (
            dev_put(lo_pad[p0:p1]), dev_put(hi_pad[p0:p1]),
            dev_put(blk_lo_pad[p0 // B:p1 // B]),
            jnp.int32(band_lo), jnp.int32(halo), jnp.int32(m_pad),
            jnp.float32(config.rsq_thr))
        if use_int8:
            from . import ld_int8  # noqa: PLC0415

            pre = ld_int8.preprocess_int8(
                band_dev(), dev_put(pos_ok_band),
                jnp.float32(config.maf_thr), n_samples=n,
                materialize_m=chunk_has_missing)
            dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(config.std_thr))
            accs = _banded_chunk_int8(
                pre, dom_ok, *chunk_args, annot_b,
                block_size=B, band_k=band_k, n_samples=n,
                n_piv_blocks=n_piv_blocks, has_missing=chunk_has_missing,
                dot_dtype=config.int8_dot_dtype)
        else:
            pre = preprocess_block(
                band_dev(), dev_put(pos_ok_band),
                jnp.float32(config.maf_thr), n_samples=n)
            dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(config.std_thr))
            accs = _banded_chunk(
                pre["add"], pre["res"], pre["usable"], dom_ok,
                pre["add_sd_zero"], *chunk_args, annot_b,
                block_size=B, band_k=band_k, n_samples=n,
                n_piv_blocks=n_piv_blocks)
        return pre, accs

    def collect(ci, pre, accs):
        """Fetch chunk ci's results to host and persist."""
        nonlocal carry, carry_a
        p0 = ci * chunk_rows
        p1 = p0 + chunk_rows
        tail = tail_a = None
        if pre == "payload":
            # fused symmetric route: ONE fetch per chunk; sentinel
            # finalization on host (f32, bitwise-identical IEEE ops)
            pay_a = None
            if annot_pad is not None:
                payload, pay_a = accs
            else:
                payload = accs
            pp = np.asarray(payload, dtype=np.float64)
            sums = pp[:, :chunk_rows]
            tail = pp[:, chunk_rows:chunk_rows + halo]
            stats = pp[:, chunk_rows + halo:]
            usable_p = stats[0] > 0
            poison_p = stats[1] > 0
            w = min(halo, chunk_rows)
            sums[:, :w] += carry[:, :w]
            nc = np.zeros_like(carry)
            if halo > chunk_rows:
                nc[:, :halo - chunk_rows] = carry[:, chunk_rows:]
            nc += tail
            carry = nc
            l2a, ws_c, poi_c, l2da, wsd_c, wse_c = sums
            l2, l2d, ws, wsd, wse = _finalize_np(
                l2a, l2da, ws_c.astype(np.int32), wsd_c.astype(np.int32),
                wse_c.astype(np.int32), poi_c.astype(np.int32),
                usable_p, poison_p)
            if pay_a is not None:
                aa = np.asarray(pay_a, dtype=np.float64)
                sums_a = aa[:, :chunk_rows]
                tail_a = aa[:, chunk_rows:]
                sums_a[:, :w] += carry_a[:, :w]
                nca = np.zeros_like(carry_a)
                if halo > chunk_rows:
                    nca[:, :halo - chunk_rows] = carry_a[:, chunk_rows:]
                nca += tail_a
                carry_a = nca
                l2a_p, l2da_p = sums_a
                good = (usable_p & (poi_c == 0))[:, None]
                self_a = annot_pad[p0:p1].astype(np.float64)
                out["l2_annot"][p0:p1] = np.where(good, self_a + l2a_p,
                                                  np.nan)
                l2d_bad = np.where(wsd_c > 0, np.nan, 0.0)[:, None]
                out["l2d_annot"][p0:p1] = np.where(
                    usable_p[:, None],
                    np.where(poison_p[:, None], l2d_bad, l2da_p), np.nan)
            out["l2"][p0:p1] = l2
            out["l2d"][p0:p1] = l2d
            out["maf"][p0:p1] = stats[2]
            out["residuals_std"][p0:p1] = stats[3]
            out["l2_ws"][p0:p1] = ws
            out["l2d_ws"][p0:p1] = wsd
            out["l2d_wse"][p0:p1] = wse
            _log_and_checkpoint(ci, p0, p1, tail, tail_a)
            return
        piv_sl = slice(lead, lead + chunk_rows)
        usable_p = np.asarray(pre["usable"])[piv_sl]
        poison_p = np.asarray(pre["add_sd_zero"])[piv_sl]
        if symmetric:
            local, tail_dev = accs[:2]
            sums = np.asarray(local, dtype=np.float64)
            tail = np.asarray(tail_dev, dtype=np.float64)
            # credits earned by EARLIER chunks for these rows
            w = min(halo, chunk_rows)
            sums[:, :w] += carry[:, :w]
            # advance the carry window to the next chunk's p0
            nc = np.zeros_like(carry)
            if halo > chunk_rows:
                nc[:, :halo - chunk_rows] = carry[:, chunk_rows:]
            nc += tail
            carry = nc
            l2a, ws_c, poi_c, l2da, wsd_c, wse_c = sums
            fin = finalize_outputs(
                jnp.asarray(l2a.astype(np.float32)),
                jnp.asarray(l2da.astype(np.float32)),
                jnp.asarray(ws_c.astype(np.int32)),
                jnp.asarray(wsd_c.astype(np.int32)),
                jnp.asarray(wse_c.astype(np.int32)),
                jnp.asarray(poi_c.astype(np.int32)),
                jnp.asarray(usable_p), jnp.asarray(poison_p))
            if annot_pad is not None:
                sums_a = np.asarray(accs[2], dtype=np.float64)  # (2, c, p)
                tail_a = np.asarray(accs[3], dtype=np.float64)  # (2, h, p)
                sums_a[:, :w] += carry_a[:, :w]
                nca = np.zeros_like(carry_a)
                if halo > chunk_rows:
                    nca[:, :halo - chunk_rows] = carry_a[:, chunk_rows:]
                nca += tail_a
                carry_a = nca
                l2a_p, l2da_p = sums_a
                good = (usable_p & (poi_c == 0))[:, None]
                self_a = annot_pad[p0:p1].astype(np.float64)
                out["l2_annot"][p0:p1] = np.where(good, self_a + l2a_p,
                                                  np.nan)
                l2d_bad = np.where(wsd_c > 0, np.nan, 0.0)[:, None]
                out["l2d_annot"][p0:p1] = np.where(
                    usable_p[:, None],
                    np.where(poison_p[:, None], l2d_bad, l2da_p), np.nan)
        else:
            flat = [np.asarray(a) for a in accs]
            fin = finalize_outputs(
                *(jnp.asarray(a.reshape(chunk_rows)) for a in flat[:6]),
                jnp.asarray(usable_p), jnp.asarray(poison_p))
            if annot_pad is not None:
                # annot sentinel semantics (mirrors ld_scores_xla_annot)
                pa = annot_pad.shape[1]
                l2a = flat[6].reshape(chunk_rows, pa).astype(np.float64)
                l2da = flat[7].reshape(chunk_rows, pa).astype(np.float64)
                wsd_c = flat[3].reshape(chunk_rows)
                poi_c = flat[5].reshape(chunk_rows)
                good = (usable_p & (poi_c == 0))[:, None]
                self_a = annot_pad[p0:p1].astype(np.float64)
                out["l2_annot"][p0:p1] = np.where(good, self_a + l2a, np.nan)
                l2d_bad = np.where(wsd_c > 0, np.nan, 0.0)[:, None]
                out["l2d_annot"][p0:p1] = np.where(
                    usable_p[:, None],
                    np.where(poison_p[:, None], l2d_bad, l2da), np.nan)
        l2, l2d, ws, wsd, wse = (np.asarray(f) for f in fin)

        out["l2"][p0:p1] = l2
        out["l2d"][p0:p1] = l2d
        out["maf"][p0:p1] = np.asarray(pre["maf"])[piv_sl]
        out["residuals_std"][p0:p1] = np.asarray(pre["rstd"])[piv_sl]
        out["l2_ws"][p0:p1] = ws
        out["l2d_ws"][p0:p1] = wsd
        out["l2d_wse"][p0:p1] = wse
        _log_and_checkpoint(ci, p0, p1, tail, tail_a)

    def _log_and_checkpoint(ci, p0, p1, tail, tail_a):
        done.add(ci)
        if ck_dir is not None:
            tmp = ck_dir / f".tmp_chunk_{ci:06d}.npz"  # savez wants .npz
            extra = {"tail": tail} if tail is not None else {}
            if tail_a is not None:
                extra["tail_a"] = tail_a
            np.savez(tmp, **{k: out[k][p0:p1] for k in out}, **extra)
            os.replace(tmp, ck_dir / f"chunk_{ci:06d}.npz")
        n_run = len(done) - n_resumed
        elapsed = time.time() - t_start
        eta = elapsed * (n_chunks - len(done)) / max(n_run, 1)
        log.info("chunk %d/%d done (%.0f%%, rows %d..%d) | elapsed %.1fs "
                 "| ETA %.1fs", len(done), n_chunks,
                 100.0 * len(done) / n_chunks, p0, p1, elapsed, eta)

    todo = [ci for ci in range(n_chunks) if ci not in done]
    n_resumed = len(done)
    t_start = time.time()
    log.info("streaming setup %.1fs (windows/rowmiss-scan/metadata "
             "staging); %d chunks to run", t_start - t_enter, len(todo))
    # component busy-times for the run decomposition (core.timing
    # STAGE_TIMES; components OVERLAP by design — read in the prefetch
    # thread, dispatch/collect on the main thread — so these attribute
    # where time is spent, they don't partition wall-clock)
    def read_band_timed(ci, tail_only=False):
        t0 = time.time()
        band = read_band(ci, tail_only)
        _stage_add("stream_read_s", t0)
        return band

    pool = ThreadPoolExecutor(max_workers=1)
    prefetch = (pool.submit(read_band_timed, todo[0], False)
                if todo else None)
    in_flight: deque = deque()  # (ci, pre, accs) pending collection
    for idx, ci in enumerate(todo):
        # chunk ci's decode overlapped the previous chunks' device compute
        t0 = time.time()
        band = prefetch.result()
        _stage_add("stream_read_wait_s", t0)
        if idx + 1 < len(todo):
            # tail-only read iff the NEXT chunk directly follows this one
            # (its band is then assembled from this chunk's retained band)
            prefetch = pool.submit(read_band_timed, todo[idx + 1],
                                   retain and todo[idx + 1] == ci + 1)

        t0 = time.time()
        in_flight.append((ci, *dispatch(ci, band, ring[idx % n_dev])))
        _stage_add("stream_dispatch_s", t0)
        # keep one rotation of chunks in flight (all devices busy), then
        # collect the oldest before reusing its device
        while len(in_flight) >= n_dev + 1:
            t0 = time.time()
            collect(*in_flight.popleft())
            _stage_add("stream_collect_s", t0)
    while in_flight:
        t0 = time.time()
        collect(*in_flight.popleft())
        _stage_add("stream_collect_s", t0)

    pool.shutdown()
    return {k: v[:m] for k, v in out.items()}
