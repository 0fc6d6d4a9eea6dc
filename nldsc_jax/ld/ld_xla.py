"""Banded block-correlation LD scores — plain-XLA path.

The reference's O(M·W·N) per-pair dot-product loop (``ldscalc.h:23-60``) is
reformulated as a *banded block matmul*: for pivot block ``b`` (``B`` SNPs),
the in-window neighbors live in blocks ``blk_lo[b] .. blk_hi[b]``; each tile
pair is one ``(B, N) @ (N, B)`` matmul followed by a fused epilogue
(adjusted r², window/usability masks, row-sum accumulation).  One pass emits
both L2 (additive) and L2D (dominance) plus the three window counters.

This module is the correctness-first f32 implementation; the integer
engines (``ld_int8.py``, ``ld_split.py``) share the mask algebra in
:func:`_tile_epilogue` and finalization in :func:`finalize_outputs`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _tile_epilogue(c_add, c_dom, gi, gj, lo_i, hi_i, usable_i, usable_j,
                   dom_ok_j, poison_j, n_samples, rsq_thr, aj=None):
    """Shared mask algebra for one (B_i × B_j) tile.

    ``c_add``/``c_dom`` are raw dot-product tiles (sum over samples, not yet
    divided by n).  Returns per-row partial sums:
    (l2_part, l2d_part, ws, wsd, wse, poison_count), extended with
    (l2_annot_part, l2d_annot_part) — the masked adjusted-r² contracted
    with the neighbor annotation slab — when ``aj`` (B_j, p) is given.
    """
    n = jnp.float32(n_samples)
    inv_n2 = 1.0 / (n - 2.0)

    r_add = c_add / n
    adj_add = r_add * r_add - (1.0 - r_add * r_add) * inv_n2
    r_dom = c_dom / n
    adj_dom = r_dom * r_dom - (1.0 - r_dom * r_dom) * inv_n2

    in_win = (gj[None, :] >= lo_i[:, None]) & (gj[None, :] <= hi_i[:, None])
    pair = in_win & usable_j[None, :] & usable_i[:, None]
    base = pair & (gj[None, :] != gi[:, None])          # exclude self
    dmask = base & dom_ok_j[None, :]

    basef = base.astype(jnp.float32)
    dmaskf = dmask.astype(jnp.float32)

    l2_part = jnp.sum(adj_add * basef, axis=1)
    l2d_part = jnp.sum(adj_dom * dmaskf, axis=1)
    ws = jnp.sum(base, axis=1).astype(jnp.int32)
    wsd = jnp.sum(dmask, axis=1).astype(jnp.int32)
    wse = jnp.sum((adj_dom > rsq_thr) & dmask, axis=1).astype(jnp.int32)
    # poison: zero-add-sd SNPs in window (self INCLUDED — ldscalc semantics)
    poison = jnp.sum(pair & poison_j[None, :], axis=1).astype(jnp.int32)
    if aj is None:
        return l2_part, l2d_part, ws, wsd, wse, poison
    # precision MUST be highest: a lower precision rounds the adjusted-r²
    # operand (bf16 or TF32, ~1e-3 per term -> ~5e-3 on the sums); the
    # skinny (B, band)@(band, p) cost is noise
    l2a = jnp.dot(adj_add * basef, aj, precision="highest",
                  preferred_element_type=jnp.float32)
    l2da = jnp.dot(adj_dom * dmaskf, aj, precision="highest",
                   preferred_element_type=jnp.float32)
    return l2_part, l2d_part, ws, wsd, wse, poison, l2a, l2da


def finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poison, usable, add_sd_zero):
    """Apply NaN/-1 sentinel semantics (ldscalc.h:16-21, SURVEY Q4)."""
    nan = jnp.float32(jnp.nan)
    l2 = jnp.where(usable & (poison == 0), 1.0 + l2_acc, nan)
    # dominance: zero-add-sd pivot -> NaN unless no neighbor passed the filter
    l2d_pivot_bad = jnp.where(wsd > 0, nan, 0.0)
    l2d = jnp.where(usable, jnp.where(add_sd_zero, l2d_pivot_bad, l2d_acc), nan)
    neg1 = jnp.int32(-1)
    ws_o = jnp.where(usable, ws, neg1)
    wsd_o = jnp.where(usable, wsd, neg1)
    wse_o = jnp.where(usable, jnp.where(add_sd_zero, 0, wse), neg1)
    return l2, l2d, ws_o, wsd_o, wse_o


@partial(jax.jit, static_argnames=("block_size", "band_k", "n_samples"))
def ld_scores_xla(add, res, lo, hi, usable, dom_ok, add_sd_zero, blk_lo,
                  blk_hi, rsq_thr, *, block_size: int, band_k: int,
                  n_samples: int):
    """Dense-in-HBM banded LD pass.

    Parameters
    ----------
    add, res : f32 (M_pad, N_pad) standardized additive / dominance-residual
        rows (from :mod:`preprocess`); padding rows must have usable=False.
    lo, hi : int32 (M_pad,) inclusive window index bounds (windows.py).
    usable, dom_ok, add_sd_zero : bool (M_pad,).
    blk_lo, blk_hi : int32 (n_blocks,) neighbor-block range per pivot block.
    rsq_thr : f32 scalar.
    block_size, band_k, n_samples : static ints.

    Returns (l2, l2d, ws, wsd, wse) each of length M_pad.
    """
    m_pad = add.shape[0]
    n_blocks = m_pad // block_size
    B = block_size
    # the band of one pivot block is CONTIGUOUS in row space, so the whole
    # neighbor set is one (band_rows, N) slab and one big matmul — far
    # better utilization than band_k separate (B, N) tiles
    band_rows = min(band_k * B, m_pad)

    def pivot_block(b):
        r0 = b * B
        ya = lax.dynamic_slice_in_dim(add, r0, B, axis=0)
        gi = r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo, r0, B)
        hi_i = lax.dynamic_slice_in_dim(hi, r0, B)
        usable_i = lax.dynamic_slice_in_dim(usable, r0, B)

        j0 = jnp.clip(blk_lo[b] * B, 0, m_pad - band_rows)
        za = lax.dynamic_slice_in_dim(add, j0, band_rows, axis=0)
        zr = lax.dynamic_slice_in_dim(res, j0, band_rows, axis=0)
        gj = j0 + jnp.arange(band_rows, dtype=jnp.int32)
        usable_j = lax.dynamic_slice_in_dim(usable, j0, band_rows)
        dom_ok_j = lax.dynamic_slice_in_dim(dom_ok, j0, band_rows)
        poison_j = lax.dynamic_slice_in_dim(add_sd_zero, j0, band_rows)

        c_add = jnp.dot(ya, za.T, precision="highest",
                        preferred_element_type=jnp.float32)
        c_dom = jnp.dot(ya, zr.T, precision="highest",
                        preferred_element_type=jnp.float32)

        return _tile_epilogue(
            c_add, c_dom, gi, gj, lo_i, hi_i, usable_i, usable_j,
            dom_ok_j, poison_j, n_samples, rsq_thr)

    accs = lax.map(pivot_block, jnp.arange(n_blocks, dtype=jnp.int32))
    l2_acc, l2d_acc, ws, wsd, wse, poison = (a.reshape(m_pad) for a in accs)
    return finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poison,
                            usable, add_sd_zero)


@partial(jax.jit, static_argnames=("block_size", "band_k", "n_samples"))
def ld_scores_xla_annot(add, res, lo, hi, usable, dom_ok, add_sd_zero, blk_lo,
                        blk_hi, rsq_thr, annot, *, block_size: int,
                        band_k: int, n_samples: int):
    """Partitioned (per-annotation) banded LD pass.

    Like :func:`ld_scores_xla` but each pair's adjusted r² is credited to
    annotation categories via the neighbor's annotation row: the tile's
    masked r² matrix is contracted with the band's annotation slab —
    ``(B, band) @ (band, p)`` — one extra skinny matmul per tile.
    The reference declares partitioned LD and never implements it
    (SURVEY Q12); there is no reference semantic to match, so we follow
    the standard LDSC convention: continuous annotation values allowed,
    the self pair contributes ``annot[i, k] * 1.0`` to L2ₖ[i] (and 0 to
    the dominance scores, mirroring the unpartitioned self-terms).

    annot : f32 (M_pad, p); padding rows must be 0.

    Returns (l2_annot (M_pad, p), l2d_annot (M_pad, p), l2, l2d, ws, wsd,
    wse) — the last five identical to :func:`ld_scores_xla`'s outputs.
    """
    m_pad = add.shape[0]
    n_blocks = m_pad // block_size
    B = block_size
    band_rows = min(band_k * B, m_pad)
    n = jnp.float32(n_samples)
    inv_n2 = 1.0 / (n - 2.0)

    def pivot_block(b):
        r0 = b * B
        ya = lax.dynamic_slice_in_dim(add, r0, B, axis=0)
        gi = r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo, r0, B)
        hi_i = lax.dynamic_slice_in_dim(hi, r0, B)
        usable_i = lax.dynamic_slice_in_dim(usable, r0, B)

        j0 = jnp.clip(blk_lo[b] * B, 0, m_pad - band_rows)
        za = lax.dynamic_slice_in_dim(add, j0, band_rows, axis=0)
        zr = lax.dynamic_slice_in_dim(res, j0, band_rows, axis=0)
        aj = lax.dynamic_slice_in_dim(annot, j0, band_rows, axis=0)
        gj = j0 + jnp.arange(band_rows, dtype=jnp.int32)
        usable_j = lax.dynamic_slice_in_dim(usable, j0, band_rows)
        dom_ok_j = lax.dynamic_slice_in_dim(dom_ok, j0, band_rows)
        poison_j = lax.dynamic_slice_in_dim(add_sd_zero, j0, band_rows)

        c_add = jnp.dot(ya, za.T, precision="highest",
                        preferred_element_type=jnp.float32)
        c_dom = jnp.dot(ya, zr.T, precision="highest",
                        preferred_element_type=jnp.float32)

        r_add = c_add / n
        adj_add = r_add * r_add - (1.0 - r_add * r_add) * inv_n2
        r_dom = c_dom / n
        adj_dom = r_dom * r_dom - (1.0 - r_dom * r_dom) * inv_n2

        in_win = (gj[None, :] >= lo_i[:, None]) & (gj[None, :] <= hi_i[:, None])
        pair = in_win & usable_j[None, :] & usable_i[:, None]
        base = pair & (gj[None, :] != gi[:, None])
        dmask = base & dom_ok_j[None, :]
        basef = base.astype(jnp.float32)
        dmaskf = dmask.astype(jnp.float32)

        l2_annot = jnp.dot(adj_add * basef, aj, precision="highest",
                           preferred_element_type=jnp.float32)
        l2d_annot = jnp.dot(adj_dom * dmaskf, aj, precision="highest",
                            preferred_element_type=jnp.float32)
        l2_part = jnp.sum(adj_add * basef, axis=1)
        l2d_part = jnp.sum(adj_dom * dmaskf, axis=1)
        ws = jnp.sum(base, axis=1).astype(jnp.int32)
        wsd = jnp.sum(dmask, axis=1).astype(jnp.int32)
        wse = jnp.sum((adj_dom > rsq_thr) & dmask, axis=1).astype(jnp.int32)
        poison = jnp.sum(pair & poison_j[None, :], axis=1).astype(jnp.int32)
        return l2_annot, l2d_annot, l2_part, l2d_part, ws, wsd, wse, poison

    accs = lax.map(pivot_block, jnp.arange(n_blocks, dtype=jnp.int32))
    p = annot.shape[1]
    l2_a, l2d_a = (a.reshape(m_pad, p) for a in accs[:2])
    l2_acc, l2d_acc, ws, wsd, wse, poison = (
        a.reshape(m_pad) for a in accs[2:])
    l2, l2d, ws_o, wsd_o, wse_o = finalize_outputs(
        l2_acc, l2d_acc, ws, wsd, wse, poison, usable, add_sd_zero)
    nan = jnp.float32(jnp.nan)
    good = (usable & (poison == 0))[:, None]
    l2_a = jnp.where(good, annot + l2_a, nan)           # + self term
    l2d_bad = jnp.where(wsd > 0, nan, 0.0)[:, None]
    l2d_a = jnp.where(usable[:, None],
                      jnp.where(add_sd_zero[:, None], l2d_bad, l2d_a), nan)
    return l2_a, l2d_a, l2, l2d, ws_o, wsd_o, wse_o


@partial(jax.jit, static_argnames=("block_size", "band_k", "right_k",
                                   "n_samples"))
def ld_scores_xla_sym(add, res, lo, hi, usable, dom_ok, add_sd_zero, blk_lo,
                      blk_hi, rsq_thr, *, block_size: int, band_k: int,
                      right_k: int, n_samples: int):
    """Symmetry-exploiting variant of :func:`ld_scores_xla` (dense only).

    The additive correlation is symmetric, so each pivot block multiplies
    only against its RIGHT half-band; the (B × right_rows) tile credits
    both its row sums (pairs (i, j≥i·B) for the pivot rows) and its column
    sums (the mirrored pairs, excluding the intra-block tile which the row
    sums already cover in both orders).  The window-interval test is
    symmetric (|Δpos| ≤ w), so one mask serves both directions.  Additive
    matmul flops halve; the (asymmetric) dominance matmul is unchanged —
    a 4/3 throughput gain overall.  ``ws`` and the poison counter are
    likewise accumulated bidirectionally; ``wsd``/``wse`` come from the
    dominance pass as before.
    """
    m_pad = add.shape[0]
    n_blocks = m_pad // block_size
    B = block_size
    band_rows = min(band_k * B, m_pad)
    # right half-band: from the pivot block itself to the rightmost neighbor
    # (right_k = host-computed max(blk_hi[b] - b) + 1)
    right_rows = min(right_k * B, m_pad)

    n = jnp.float32(n_samples)
    inv_n2 = 1.0 / (n - 2.0)

    def step(carry, b):
        l2_full, ws_full, poi_full = carry
        r0 = b * B
        ya = lax.dynamic_slice_in_dim(add, r0, B, axis=0)
        gi = r0 + jnp.arange(B, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo, r0, B)
        hi_i = lax.dynamic_slice_in_dim(hi, r0, B)
        usable_i = lax.dynamic_slice_in_dim(usable, r0, B)
        poison_i = lax.dynamic_slice_in_dim(add_sd_zero, r0, B)

        # --- additive: right half-band, bidirectional credit ---
        j0r = jnp.minimum(r0, m_pad - right_rows)
        za = lax.dynamic_slice_in_dim(add, j0r, right_rows, axis=0)
        gj = j0r + jnp.arange(right_rows, dtype=jnp.int32)
        usable_j = lax.dynamic_slice_in_dim(usable, j0r, right_rows)
        poison_j = lax.dynamic_slice_in_dim(add_sd_zero, j0r, right_rows)

        c_add = jnp.dot(ya, za.T, precision="highest",
                        preferred_element_type=jnp.float32)
        r_add = c_add / n
        adj_add = r_add * r_add - (1.0 - r_add * r_add) * inv_n2

        in_win = (gj[None, :] >= lo_i[:, None]) & (gj[None, :] <= hi_i[:, None])
        upair = in_win & usable_j[None, :] & usable_i[:, None]
        fwd = gj[None, :] >= r0            # guard vs clipped j0r re-visits
        row_base = upair & fwd & (gj[None, :] != gi[:, None])
        col_base = upair & (gj[None, :] >= r0 + B)  # intra handled by rows

        rowf = row_base.astype(jnp.float32)
        colf = col_base.astype(jnp.float32)
        l2_row = jnp.sum(adj_add * rowf, axis=1)
        l2_col = jnp.sum(adj_add * colf, axis=0)
        ws_row = jnp.sum(row_base, axis=1).astype(jnp.int32)
        ws_col = jnp.sum(col_base, axis=0).astype(jnp.int32)
        # poison counts include self (pair mask without self-exclusion)
        poi_row = jnp.sum((upair & fwd & poison_j[None, :]), axis=1).astype(jnp.int32)
        poi_col = jnp.sum((upair & poison_i[:, None] &
                           (gj[None, :] >= r0 + B)), axis=0).astype(jnp.int32)

        def credit(full, at, vals):
            cur = lax.dynamic_slice_in_dim(full, at, vals.shape[0])
            return lax.dynamic_update_slice_in_dim(full, cur + vals, at, 0)

        l2_full = credit(credit(l2_full, r0, l2_row), j0r, l2_col)
        ws_full = credit(credit(ws_full, r0, ws_row), j0r, ws_col)
        poi_full = credit(credit(poi_full, r0, poi_row), j0r, poi_col)

        # --- dominance: full band (asymmetric), unchanged semantics ---
        j0 = jnp.clip(blk_lo[b] * B, 0, m_pad - band_rows)
        zr = lax.dynamic_slice_in_dim(res, j0, band_rows, axis=0)
        gjd = j0 + jnp.arange(band_rows, dtype=jnp.int32)
        usable_jd = lax.dynamic_slice_in_dim(usable, j0, band_rows)
        dom_ok_j = lax.dynamic_slice_in_dim(dom_ok, j0, band_rows)
        valid_k = gjd <= blk_hi[b] * B + (B - 1)

        c_dom = jnp.dot(ya, zr.T, precision="highest",
                        preferred_element_type=jnp.float32)
        r_dom = c_dom / n
        adj_dom = r_dom * r_dom - (1.0 - r_dom * r_dom) * inv_n2
        in_win_d = ((gjd[None, :] >= lo_i[:, None]) &
                    (gjd[None, :] <= hi_i[:, None]) & valid_k[None, :])
        dmask = (in_win_d & usable_jd[None, :] & usable_i[:, None] &
                 (gjd[None, :] != gi[:, None]) & dom_ok_j[None, :])
        dmaskf = dmask.astype(jnp.float32)
        l2d_b = jnp.sum(adj_dom * dmaskf, axis=1)
        wsd_b = jnp.sum(dmask, axis=1).astype(jnp.int32)
        wse_b = jnp.sum((adj_dom > rsq_thr) & dmask, axis=1).astype(jnp.int32)

        return (l2_full, ws_full, poi_full), (l2d_b, wsd_b, wse_b)

    zero_f = jnp.zeros(m_pad, jnp.float32)
    zero_i = jnp.zeros(m_pad, jnp.int32)
    (l2_acc, ws, poison), (l2d_b, wsd_b, wse_b) = lax.scan(
        step, (zero_f, zero_i, zero_i), jnp.arange(n_blocks, dtype=jnp.int32))
    l2d_acc = l2d_b.reshape(m_pad)
    wsd = wsd_b.reshape(m_pad)
    wse = wse_b.reshape(m_pad)
    return finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poison,
                            usable, add_sd_zero)
