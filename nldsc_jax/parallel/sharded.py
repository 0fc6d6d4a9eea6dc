"""SNP-sharded LD scores: shard_map + ppermute halo exchange.

Structure (the multi-device replacement for the reference's single-threaded
sliding-window cache, ``stream.h:106-198``):

* the padded SNP axis is split evenly over the 1-D ``snp`` mesh; every
  shard *owns* its rows' outputs (no cross-device reductions at all;
  results are bitwise-invariant in the DEVICE COUNT, integer counters
  exactly equal to the single-device slab engine, f32 score sums equal to
  it within summation-order ulps — see ``mesh.py`` for the full contract);
* preprocessing (impute/standardize/residualize) runs shard-local;
* each shard sends its first/last ``H`` preprocessed rows to its ring
  neighbors with ``lax.ppermute`` (non-wrapping: edge shards receive zeros,
  which are masked out by global-index bounds), where ``H`` covers the
  maximum one-sided window span;
* the banded slab matmul then runs entirely shard-local against the
  halo-extended (L + 2H, N) arrays.

When the window span exceeds what a single-hop halo can cover
(H > L), the driver falls back to replicating the preprocessed arrays
(`all_gather`) — correct at any window size, just more memory traffic.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ld.ld_xla import _tile_epilogue, finalize_outputs
from ..ld.preprocess import preprocess_block
from .mesh import SNP_AXIS


def _halo_exchange(x: jnp.ndarray, h: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Return (from_left, from_right) halo rows of width h (zeros at edges).

    When h exceeds the shard length L, rows come from shards further than
    the ring neighbors: hop k ppermutes each shard's full row block by k
    positions, and the halo is assembled from ceil(h/L) hops.
    """
    n_shards = lax.axis_size(SNP_AXIS)
    L = x.shape[0]

    def perm(hop, direction):
        if direction > 0:   # send right: shard i -> i+hop (from_left source)
            return [(i, i + hop) for i in range(n_shards - hop)]
        return [(i + hop, i) for i in range(n_shards - hop)]

    if h <= L:  # single hop: ship only the needed edge rows
        from_left = lax.ppermute(x[-h:], SNP_AXIS, perm(1, +1))
        from_right = lax.ppermute(x[:h], SNP_AXIS, perm(1, -1))
        return from_left, from_right

    n_hops = -(-h // L)
    lefts = [lax.ppermute(x, SNP_AXIS, perm(k, +1))
             for k in range(n_hops, 0, -1)]           # far -> near
    rights = [lax.ppermute(x, SNP_AXIS, perm(k, -1))
              for k in range(1, n_hops + 1)]          # near -> far
    from_left = jnp.concatenate(lefts, axis=0)[-h:]
    from_right = jnp.concatenate(rights, axis=0)[:h]
    return from_left, from_right


def _extend(x: jnp.ndarray, h: int) -> jnp.ndarray:
    if h == 0:  # single shard: x[-0:] would be the whole array
        return x
    fl, fr = _halo_exchange(x, h)
    return jnp.concatenate([fl, x, fr], axis=0)


def _shard_fn_int8(g, pos_ok, lo, hi, blk_lo, blk_hi, annot=None, *,
                   maf_thr, std_thr, rsq_thr, n_samples, block_size,
                   band_k, halo_rows, m_pad, has_missing, dot_dtype):
    """Integer-engine shard body: halo-exchanges int8 genotype codes (4x
    less ICI traffic than f32) plus the per-SNP scalar row.

    ``annot``: optional f32 (L, p) local annotation rows (sharded like
    ``g``) — halo-extended alongside the codes so each pivot block can
    contract the masked adjusted-r² tile with its band's annotation slab
    (partitioned LD shards exactly like the counters: per-pivot outputs,
    no extra collectives)."""
    from ..ld.ld_int8 import (corr_tiles, make_idot,  # noqa: PLC0415
                              preprocess_int8, scal_views, stack_scalars)

    B = block_size
    L = g.shape[0]
    H = halo_rows
    shard = lax.axis_index(SNP_AXIS)
    shard_start = shard * L

    pre = preprocess_int8(g, pos_ok, jnp.float32(maf_thr),
                          n_samples=n_samples)
    usable = pre["usable"]
    dom_ok = usable & (pre["rstd"] > jnp.float32(std_thr))
    poison = pre["add_sd_zero"]

    g_ext = _extend(pre["g"], H)
    m_ext = _extend(pre["m"], H)
    h_ext = _extend(pre["h"], H)
    scal = stack_scalars(pre)                 # (L, 9)
    scalars = jnp.concatenate([
        scal, jnp.stack([usable, dom_ok, poison], axis=1).astype(jnp.float32),
    ], axis=1)                                # + flags at cols 9..11
    scal_ext = _extend(scalars, H)
    a_ext = None if annot is None else _extend(annot, H)

    band_rows = min(band_k * B, L + 2 * H)
    ext_rows = L + 2 * H
    n = jnp.float32(n_samples)
    n_pad_cols = g.shape[1]
    n_padf = jnp.float32(n_pad_cols)
    idot = make_idot(dot_dtype)

    def pivot_block(b_local):
        gb = shard * (L // B) + b_local
        r0 = b_local * B
        gi_rows = lax.dynamic_slice_in_dim(g_ext, H + r0, B, axis=0)
        mi_rows = lax.dynamic_slice_in_dim(m_ext, H + r0, B, axis=0)
        gi = shard_start + r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo, shard_start + r0, B)
        hi_i = lax.dynamic_slice_in_dim(hi, shard_start + r0, B)
        usable_i = lax.dynamic_slice_in_dim(usable, r0, B)
        sc_i = scal_views(lax.dynamic_slice_in_dim(scal, r0, B, axis=0), "col")

        j0_ext = jnp.clip(blk_lo[gb] * B - (shard_start - H),
                          0, ext_rows - band_rows)
        gj_rows = lax.dynamic_slice_in_dim(g_ext, j0_ext, band_rows, axis=0)
        mj_rows = lax.dynamic_slice_in_dim(m_ext, j0_ext, band_rows, axis=0)
        hj_rows = lax.dynamic_slice_in_dim(h_ext, j0_ext, band_rows, axis=0)
        sc = lax.dynamic_slice_in_dim(scal_ext, j0_ext, band_rows, axis=0)
        gj = (shard_start - H) + j0_ext + jnp.arange(band_rows, dtype=jnp.int32)

        in_range = (gj >= 0) & (gj < m_pad)
        usable_j = (sc[:, 9] > 0) & in_range
        dom_ok_j = (sc[:, 10] > 0) & in_range
        poison_j = (sc[:, 11] > 0) & in_range
        sc_j = scal_views(sc[:, :9], "row")

        r_add, r_dom = corr_tiles(
            idot, gi_rows, mi_rows, None, gj_rows, mj_rows, hj_rows,
            sc_i, sc_j, n, n_padf, has_missing)
        aj = (None if a_ext is None else
              lax.dynamic_slice_in_dim(a_ext, j0_ext, band_rows, axis=0))
        return _tile_epilogue(r_add * n, r_dom * n, gi, gj, lo_i, hi_i,
                              usable_i, usable_j, dom_ok_j, poison_j,
                              n_samples, rsq_thr, aj=aj)

    accs = lax.map(pivot_block, jnp.arange(L // B, dtype=jnp.int32))
    flat = tuple(a.reshape(L) for a in accs[:6])
    if annot is not None:
        flat = flat + tuple(a.reshape(L, -1) for a in accs[6:])
    return flat + (usable, poison, pre["maf"], pre["rstd"])


def _shard_fn_int8_sym(g, pos_ok, lo, hi, blk_lo, blk_hi, *, maf_thr,
                       std_thr, rsq_thr, n_samples, block_size, right_k,
                       halo_rows, m_pad, has_missing, dot_dtype):
    """Symmetric integer shard body.

    Each pair is computed once, by the shard owning its LEFT member: data
    halo flows only leftward (each shard receives its successors' first H
    rows), and after the local right-half-band pass the column credits
    that landed on halo rows are ppermuted BACK to their owning shards.
    Halo traffic halves vs the full-band shard body (right-only), matmul
    flops drop to 3/8 half-band products (vs 2/6 full-band) — the same
    4/3 (resp. 3/2) saving as the in-core symmetric engine.

    Bitwise determinism: column credits are kept as PER-PIVOT-BLOCK
    vectors (not folded into a running carry), predecessors ship their
    last ``right_k - 1`` blocks' vectors back, and every row's total is
    assembled by one ascending-pivot-block left fold followed by the row
    sums — the exact f32 grouping the in-core scan produces.  Because
    the fold order depends only on BLOCK indices (never on where shard
    boundaries fall), l2/l2d are bitwise-invariant in the device count
    (asserted in tests/test_sharded.py and the driver dryrun).
    """
    from ..ld.ld_int8 import (corr_tiles, make_idot,  # noqa: PLC0415
                              preprocess_int8, scal_views, stack_scalars)

    B = block_size
    L = g.shape[0]
    H = halo_rows
    n_shards = lax.axis_size(SNP_AXIS)
    shard = lax.axis_index(SNP_AXIS)
    shard_start = shard * L

    pre = preprocess_int8(g, pos_ok, jnp.float32(maf_thr),
                          n_samples=n_samples)
    usable = pre["usable"]
    dom_ok = usable & (pre["rstd"] > jnp.float32(std_thr))
    poison = pre["add_sd_zero"]

    def right_halo(x):
        """First H rows of the successor shards (zeros past the end)."""
        if H == 0:
            return x[:0]
        n_hops = -(-H // L)
        if n_hops == 1:
            perm = [(i + 1, i) for i in range(n_shards - 1)]
            return lax.ppermute(x[:H], SNP_AXIS, perm)
        parts = [lax.ppermute(x, SNP_AXIS,
                              [(i + k, i) for i in range(n_shards - k)])
                 for k in range(1, n_hops + 1)]
        return jnp.concatenate(parts, axis=0)[:H]

    # every pivot block's band is anchored AT the block (j0 = r0, never
    # clamped): zero rows pad the halo so the last block's full-width
    # band always fits.  Out-of-range columns are masked by gj < m_pad;
    # the fixed anchor is what makes the per-block credit vectors
    # fold-able in a device-count-independent order (see below).
    right_rows = min(right_k * B, m_pad)
    pad_rows = max(0, (L - B) + right_rows - (L + H))

    def ext(x):
        halo = right_halo(x)
        zeros = jnp.zeros((pad_rows,) + x.shape[1:], x.dtype)
        return jnp.concatenate([x, halo, zeros], axis=0)

    g_ext = ext(pre["g"])
    m_ext = ext(pre["m"])
    h_ext = ext(pre["h"])
    scal = stack_scalars(pre)                 # (L, 9)
    scalars = jnp.concatenate([
        scal, jnp.stack([usable, dom_ok, poison], axis=1).astype(jnp.float32),
    ], axis=1)                                # + flags at cols 9..11
    sc_ext = ext(scalars)

    n = jnp.float32(n_samples)
    n_pad_cols = g.shape[1]
    n_padf = jnp.float32(n_pad_cols)
    inv_n2 = 1.0 / (n - 2.0)
    idot = make_idot(dot_dtype)

    def sl(v, at, size):
        return lax.dynamic_slice_in_dim(v, at, size)

    def step(b_local):
        r0 = b_local * B
        gr0 = shard_start + r0
        gi = gr0 + jnp.arange(B, dtype=jnp.int32)
        g_i = lax.dynamic_slice_in_dim(g_ext, r0, B, axis=0)
        m_i = lax.dynamic_slice_in_dim(m_ext, r0, B, axis=0)
        h_i = lax.dynamic_slice_in_dim(h_ext, r0, B, axis=0)
        lo_i = sl(lo, gr0, B)[:, None]
        hi_i = sl(hi, gr0, B)[:, None]
        sc_im = lax.dynamic_slice_in_dim(sc_ext, r0, B, axis=0)
        usable_i = (sc_im[:, 9] > 0)[:, None]
        dom_ok_i = (sc_im[:, 10] > 0)[:, None]
        poison_i = (sc_im[:, 11] > 0)[:, None]
        sc_i = scal_views(sc_im[:, :9], "col")

        j0 = r0                     # fixed anchor (padding absorbs the tail)
        gj = shard_start + j0 + jnp.arange(right_rows, dtype=jnp.int32)
        g_j = lax.dynamic_slice_in_dim(g_ext, j0, right_rows, axis=0)
        m_j = lax.dynamic_slice_in_dim(m_ext, j0, right_rows, axis=0)
        h_j = lax.dynamic_slice_in_dim(h_ext, j0, right_rows, axis=0)
        sc_jm = lax.dynamic_slice_in_dim(sc_ext, j0, right_rows, axis=0)
        in_range = gj < m_pad
        usable_j = ((sc_jm[:, 9] > 0) & in_range)[None, :]
        dom_ok_j = ((sc_jm[:, 10] > 0) & in_range)[None, :]
        poison_j = ((sc_jm[:, 11] > 0) & in_range)[None, :]
        sc_j = scal_views(sc_jm[:, :9], "row")

        r_add, r_domA, r_domB = corr_tiles(
            idot, g_i, m_i, h_i, g_j, m_j, h_j, sc_i, sc_j, n, n_padf,
            has_missing, symmetric=True)

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
        return rows_b, cols_b

    nb = L // B
    rows_s, cols_s = lax.map(step, jnp.arange(nb, dtype=jnp.int32))
    # rows_s: (nb, 6, B) — disjoint per block; cols_s: (nb, 6, right_rows)
    # where block b's vector covers rows [b·B, b·B + right_rows).
    rows_flat = jnp.moveaxis(rows_s, 1, 0).reshape(6, L)

    # deterministic column fold: a row in block c must receive its credits
    # in ascending pivot-block order (c-q, ..., c-1) regardless of where
    # shard boundaries fall, so predecessors ship their last q = right_k-1
    # blocks' UNFOLDED vectors and the fold below runs over block distance
    # k descending (= pivot block ascending) — the same left-fold grouping
    # the in-core scan produces.
    q = max(right_rows // B - 1, 0)
    if q > 0:
        n_hops_c = -(-q // nb)
        parts = []
        for h in range(n_hops_c, 0, -1):          # farthest first
            take = min(nb, q - (h - 1) * nb)
            seg = cols_s if take == nb else cols_s[nb - take:]
            perm = [(i, i + h) for i in range(n_shards - h)]
            parts.append(lax.ppermute(seg, SNP_AXIS, perm))
        parts.append(cols_s)
        c_ext = jnp.concatenate(parts, axis=0)    # (q + nb, 6, right_rows)
        acc_blocks = jnp.zeros((nb, 6, B), jnp.float32)
        for k in range(q, 0, -1):
            acc_blocks = acc_blocks + c_ext[q - k: q - k + nb, :,
                                            k * B:(k + 1) * B]
        cols_flat = jnp.moveaxis(acc_blocks, 1, 0).reshape(6, L)
    else:
        cols_flat = jnp.zeros((6, L), jnp.float32)
    # intra-block column credits are impossible (col_base needs
    # j >= r0 + B), so segment k = 0 of each block's vector is zero.
    acc = cols_flat + rows_flat
    l2_acc, ws, poi, l2d_acc, wsd, wse = acc
    return (l2_acc, l2d_acc, ws.astype(jnp.int32), wsd.astype(jnp.int32),
            wse.astype(jnp.int32), poi.astype(jnp.int32),
            usable, poison, pre["maf"], pre["rstd"])


def _shard_fn(g, pos_ok, lo, hi, blk_lo, blk_hi, annot=None, *, maf_thr,
              std_thr, rsq_thr, n_samples, block_size, band_k, halo_rows,
              m_pad):
    """Per-shard computation inside shard_map.

    g : int8 (L, N_pad) local genotype rows;
    pos_ok : bool (L,) local; lo/hi/blk_lo/blk_hi : replicated (global);
    annot : optional f32 (L, p) local annotation rows (halo-extended).
    """
    B = block_size
    L = g.shape[0]
    H = halo_rows
    shard = lax.axis_index(SNP_AXIS)
    shard_start = shard * L

    pre = preprocess_block(g, pos_ok, jnp.float32(maf_thr),
                           n_samples=n_samples)
    usable = pre["usable"]
    dom_ok = usable & (pre["rstd"] > jnp.float32(std_thr))
    poison = pre["add_sd_zero"]

    # halo-extend data + device-computed masks (window bounds are replicated)
    add_ext = _extend(pre["add"], H)
    res_ext = _extend(pre["res"], H)
    meta_local = jnp.stack([usable, dom_ok, poison], axis=1).astype(jnp.int32)
    meta_ext = _extend(meta_local, H)
    a_ext = None if annot is None else _extend(annot, H)

    band_rows = min(band_k * B, L + 2 * H)
    ext_rows = L + 2 * H

    def pivot_block(b_local):
        gb = shard * (L // B) + b_local             # global pivot block
        r0 = b_local * B
        ya = lax.dynamic_slice_in_dim(add_ext, H + r0, B, axis=0)
        gi = shard_start + r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo, shard_start + r0, B)
        hi_i = lax.dynamic_slice_in_dim(hi, shard_start + r0, B)
        usable_i = lax.dynamic_slice_in_dim(usable, r0, B)

        j0_ext = jnp.clip(blk_lo[gb] * B - (shard_start - H),
                          0, ext_rows - band_rows)
        za = lax.dynamic_slice_in_dim(add_ext, j0_ext, band_rows, axis=0)
        zr = lax.dynamic_slice_in_dim(res_ext, j0_ext, band_rows, axis=0)
        mj = lax.dynamic_slice_in_dim(meta_ext, j0_ext, band_rows, axis=0)
        gj = (shard_start - H) + j0_ext + jnp.arange(band_rows, dtype=jnp.int32)

        in_range = (gj >= 0) & (gj < m_pad)
        usable_j = (mj[:, 0] > 0) & in_range
        dom_ok_j = (mj[:, 1] > 0) & in_range
        poison_j = (mj[:, 2] > 0) & in_range

        c_add = jnp.dot(ya, za.T, precision="highest",
                        preferred_element_type=jnp.float32)
        c_dom = jnp.dot(ya, zr.T, precision="highest",
                        preferred_element_type=jnp.float32)
        aj = (None if a_ext is None else
              lax.dynamic_slice_in_dim(a_ext, j0_ext, band_rows, axis=0))
        return _tile_epilogue(c_add, c_dom, gi, gj, lo_i, hi_i, usable_i,
                              usable_j, dom_ok_j, poison_j, n_samples,
                              rsq_thr, aj=aj)

    accs = lax.map(pivot_block, jnp.arange(L // B, dtype=jnp.int32))
    flat = tuple(a.reshape(L) for a in accs[:6])
    if annot is not None:
        flat = flat + tuple(a.reshape(L, -1) for a in accs[6:])
    return flat + (usable, poison, pre["maf"], pre["rstd"])


@partial(jax.jit,
         static_argnames=("maf_thr", "std_thr", "rsq_thr", "n_samples",
                          "block_size", "band_k", "right_k", "halo_rows",
                          "mesh", "use_int8", "symmetric",
                          "has_missing", "dot_dtype"))
def _sharded_call(g, pos_ok, lo, hi, blk_lo, blk_hi, annot=None, *,
                  maf_thr, std_thr, rsq_thr, n_samples, block_size,
                  band_k, right_k, halo_rows, mesh,
                  use_int8=False, symmetric=False, has_missing=True,
                  dot_dtype="int8"):
    m_pad = g.shape[0]
    if annot is not None and symmetric:
        raise ValueError("annot requires the full-band shard body "
                         "(callers route symmetric=False for annot)")
    if use_int8 and symmetric:
        fn = partial(_shard_fn_int8_sym, maf_thr=maf_thr, std_thr=std_thr,
                     rsq_thr=jnp.float32(rsq_thr), n_samples=n_samples,
                     block_size=block_size, right_k=right_k,
                     halo_rows=halo_rows, m_pad=m_pad,
                     has_missing=has_missing, dot_dtype=dot_dtype)
    elif use_int8:
        fn = partial(_shard_fn_int8, maf_thr=maf_thr, std_thr=std_thr,
                     rsq_thr=jnp.float32(rsq_thr), n_samples=n_samples,
                     block_size=block_size, band_k=band_k,
                     halo_rows=halo_rows, m_pad=m_pad,
                     has_missing=has_missing, dot_dtype=dot_dtype)
    else:
        fn = partial(_shard_fn, maf_thr=maf_thr, std_thr=std_thr,
                     rsq_thr=jnp.float32(rsq_thr), n_samples=n_samples,
                     block_size=block_size, band_k=band_k,
                     halo_rows=halo_rows, m_pad=m_pad)
    sharded = P(SNP_AXIS)
    repl = P()
    in_specs = (sharded, sharded, repl, repl, repl, repl)
    args = (g, pos_ok, lo, hi, blk_lo, blk_hi)
    n_out = 10
    if annot is not None:
        in_specs = in_specs + (sharded,)
        args = args + (annot,)
        n_out = 12
    out = jax.shard_map(
        fn, mesh=mesh,
        in_specs=in_specs,
        out_specs=tuple([sharded] * n_out),
    )(*args)
    l2_acc, l2d_acc, ws, wsd, wse, poi = out[:6]
    usable, add_sd_zero, maf, rstd = out[-4:]
    l2, l2d, ws_o, wsd_o, wse_o = finalize_outputs(
        l2_acc, l2d_acc, ws, wsd, wse, poi, usable, add_sd_zero)
    nan = jnp.float32(jnp.nan)
    rstd_o = jnp.where(usable & ~add_sd_zero, rstd, nan)
    if annot is None:
        return l2, l2d, ws_o, wsd_o, wse_o, maf, rstd_o
    from ..ld.ld_int8 import finalize_annot  # noqa: PLC0415
    l2_a, l2d_a = finalize_annot(out[6], out[7], annot, usable,
                                 add_sd_zero, poi, wsd)
    return l2, l2d, ws_o, wsd_o, wse_o, maf, rstd_o, l2_a, l2d_a


def sharded_geometry(m: int, n: int, positions: np.ndarray, config, mesh):
    """Host-side padded geometry shared by the sharded entry points.

    Returns ``(m_pad, n_pad, meta, kwargs)`` where ``meta`` is the tuple of
    replicated metadata arrays for :func:`_sharded_call` and ``kwargs`` its
    static keyword arguments (minus ``has_missing``).
    """
    from ..ld import windows  # noqa: PLC0415

    B = config.block_size
    n_dev = mesh.devices.size
    chunk = B * n_dev
    m_pad = -(-m // chunk) * chunk
    n_pad = -(-n // 128) * 128
    L = m_pad // n_dev
    if B > L:
        raise ValueError(f"block_size {B} exceeds shard rows {L}")

    lo, hi, pos_ok = windows.window_bounds(positions, config.ld_wind)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, m_pad // B)
    halo = windows.max_halo_rows(lo, hi)
    # cap at m_pad - L: beyond that every other shard's rows are already
    # in the halo (degenerates to a replicated extend, still correct)
    halo_rows = min(-(-halo // B) * B, m_pad - L)

    pos_ok_pad = np.zeros(m_pad, dtype=bool)
    pos_ok_pad[:m] = pos_ok
    lo_pad = np.concatenate([lo, np.full(m_pad - m, m_pad, np.int32)]).astype(np.int32)
    hi_pad = np.concatenate([hi, np.full(m_pad - m, -1, np.int32)]).astype(np.int32)

    # same default policy as the single-device driver: integer engine and
    # the symmetric formulation always (scripts/time_sym2.py measurements)
    use_int8 = config.use_int8 if config.use_int8 is not None else True
    symmetric = ((config.symmetric if config.symmetric is not None else True)
                 and use_int8)
    right_k = windows.right_band_blocks(blk_hi, B)

    meta = (jnp.asarray(pos_ok_pad), jnp.asarray(lo_pad),
            jnp.asarray(hi_pad), jnp.asarray(blk_lo), jnp.asarray(blk_hi))
    kwargs = dict(
        maf_thr=float(config.maf_thr), std_thr=float(config.std_thr),
        rsq_thr=float(config.rsq_thr), n_samples=n, block_size=B,
        band_k=band_k, right_k=right_k, halo_rows=halo_rows,
        mesh=mesh,
        use_int8=use_int8, symmetric=symmetric,
        dot_dtype=config.int8_dot_dtype)
    return m_pad, n_pad, meta, kwargs


def ld_scores_sharded_global(g_global, positions: np.ndarray, config, mesh,
                             m: int, n: int, annot_global=None) -> dict:
    """Sharded LD scores on an ALREADY-sharded global genotype array.

    The mesh-level multi-host entry point (SURVEY §2.2 P4): each process
    byte-range-decodes only its own row range of the .bed and assembles
    ``g_global`` with ``jax.make_array_from_process_local_data`` (see
    :mod:`nldsc_jax.parallel.distributed`) — no host ever holds the full
    matrix.  ``g_global`` must be (m_pad, n_pad) int8, padding rows/cols
    -1, sharded ``P(SNP_AXIS)`` over ``mesh``.

    ``annot_global``: optional (m_pad, p) f32 annotation rows, sharded
    like ``g_global`` (partitioned LD; routed full-band).

    ``has_missing`` is pinned True (the compiled program must be identical
    on every process; scanning the data would need a pre-pass collective).
    """
    m_pad, n_pad, meta, kwargs = sharded_geometry(m, n, positions, config,
                                                  mesh)
    if tuple(g_global.shape) != (m_pad, n_pad):
        raise ValueError(f"g_global shape {g_global.shape} != padded "
                         f"({m_pad}, {n_pad})")
    if annot_global is not None:
        kwargs["symmetric"] = False
    with mesh:
        outs = _sharded_call(g_global, *meta, annot_global,
                             has_missing=True, **kwargs)

    l2, l2d, ws, wsd, wse, maf, rstd = outs[:7]
    result = {
        "l2": np.asarray(l2, dtype=np.float64)[:m],
        "l2d": np.asarray(l2d, dtype=np.float64)[:m],
        "maf": np.asarray(maf, dtype=np.float64)[:m],
        "residuals_std": np.asarray(rstd, dtype=np.float64)[:m],
        "l2_ws": np.asarray(ws, dtype=np.int64)[:m],
        "l2d_ws": np.asarray(wsd, dtype=np.int64)[:m],
        "l2d_wse": np.asarray(wse, dtype=np.int64)[:m],
    }
    if annot_global is not None:
        result["l2_annot"] = np.asarray(outs[7], dtype=np.float64)[:m]
        result["l2d_annot"] = np.asarray(outs[8], dtype=np.float64)[:m]
    return result


def ld_scores_sharded(genotypes, positions: np.ndarray, config,
                      mesh, annot: np.ndarray | None = None) -> dict:
    """Sharded in-core LD scores over a 1-D device mesh.

    Same host contract as ``pipeline.compute_ld_scores`` but the genotype
    matrix is scattered row-wise over ``mesh`` and everything downstream —
    preprocessing, halo exchange, banded matmuls — runs under shard_map.

    ``genotypes`` may be an int8 (M, N) array or a
    :class:`nldsc_jax.io.plink.PackedBed`: packed rows are scattered over
    the mesh and unpacked on device (4× less host→device transfer).

    ``annot``: optional (M, p) annotation matrix — partitioned LD.  The
    annotation rows shard and halo-exchange exactly like the genotype
    rows (per-pivot outputs, no extra collectives); routed through the
    full-band shard body (the in-core measured choice for annot,
    ld/pipeline.py).  Extends the result with ``l2_annot``/``l2d_annot``.
    """
    from ..io.plink import PackedBed  # noqa: PLC0415

    packed = isinstance(genotypes, PackedBed)
    m, n = genotypes.shape
    m_pad, n_pad, meta, kwargs = sharded_geometry(m, n, positions, config,
                                                  mesh)
    a_dev = None
    if annot is not None:
        kwargs["symmetric"] = False   # annot runs the full-band shard body
        a_pad = np.zeros((m_pad, np.asarray(annot).shape[1]), np.float32)
        a_pad[:m] = np.asarray(annot, dtype=np.float32)
        a_dev = jnp.asarray(a_pad)

    if packed:
        from ..ld.preprocess import unpack_bed  # noqa: PLC0415

        raw = np.full((m_pad, genotypes.raw.shape[1]), 0x55, dtype=np.uint8)
        raw[:m] = genotypes.raw
        has_missing = genotypes.has_missing
        sharding = NamedSharding(mesh, P(SNP_AXIS))
        raw_dev = jax.device_put(raw, sharding)
        with mesh:
            g_dev = unpack_bed(raw_dev, n_samples=n, n_pad=n_pad,
                               pad_val=-1)
    else:
        g = np.full((m_pad, n_pad), -1, dtype=np.int8)
        g[:m, :n] = genotypes
        has_missing = bool((genotypes < 0).any())
        g_dev = jnp.asarray(g)

    with mesh:
        outs = _sharded_call(g_dev, *meta, a_dev,
                             has_missing=has_missing, **kwargs)

    l2, l2d, ws, wsd, wse, maf, rstd = outs[:7]
    result = {
        "l2": np.asarray(l2, dtype=np.float64)[:m],
        "l2d": np.asarray(l2d, dtype=np.float64)[:m],
        "maf": np.asarray(maf, dtype=np.float64)[:m],
        "residuals_std": np.asarray(rstd, dtype=np.float64)[:m],
        "l2_ws": np.asarray(ws, dtype=np.int64)[:m],
        "l2d_ws": np.asarray(wsd, dtype=np.int64)[:m],
        "l2d_wse": np.asarray(wse, dtype=np.int64)[:m],
    }
    if annot is not None:
        result["l2_annot"] = np.asarray(outs[7], dtype=np.float64)[:m]
        result["l2d_annot"] = np.asarray(outs[8], dtype=np.float64)[:m]
    return result
