"""Split-missing symmetric integer engine: clean-rate LD with sparse missing.

The global integer engines pay the 8-matmul missing epilogue for EVERY
tile as soon as ANY genotype in the matrix is missing (``has_missing`` is
a whole-pass static).  But the missing corrections are nonzero only for
pairs where at least one member row actually contains a missing genotype
— in real data a minority of SNPs.  This engine makes the missing cost
proportional to that minority:

  pass 1 — the UNMODIFIED clean symmetric pass over *all* pairs
      (``ld_int8.sym_scan_segment`` with ``has_missing=False`` in-core;
      the clean chunk pass in streaming).  For pairs of two clean rows
      this is already exact (their ``u``-dots collapse to per-row
      integer sums); for pairs touching a contaminated row it produces
      a deterministic wrong value that pass 2 cancels.

  pass 2 (:func:`split_corrections`) — exact corrections
      ``δ = adj(r_exact) − adj(r_clean)`` for every pair with a
      contaminated member: all ordered pairs (x, contaminated c) are
      enumerated with x swept in LARGE row segments, so each big operand
      is read once per segment — for x CLEAN the m_x-side dots collapse
      analytically (smg = smh = 0, smm = the padding overlap constant),
      leaving TWO big launches per segment plus a tiny compact product
      for the contaminated-x rows, in place of a per-block fused form
      (K-loop-bound launches) and of the global 8-matmul engine.  The
      SAME kernel serves the streaming driver: it runs on each chunk's
      band in local coordinates with ``own_hi = chunk_rows``, so every
      global pair is corrected exactly once by the chunk owning its
      left member, and the band-length δ vectors split into local
      credits plus the forward tail like the chunk pass outputs.

Exactness: contaminated-pair values come from the SAME exact integer
S-matrices as the global engine, and the corrections re-evaluate every
pair in the orientation pass 1 used (left member as i — entries with a
contaminated left member select role-swapped expressions), so adjusted
r² values are BITWISE identical and the value-dependent WSE counter
matches the global engine exactly; the f32 L2/L2D sums differ only by
summation order (≤ a few ulp).

Reference semantics anchor: per-pair adjusted r² and counters,
``ldscalc.h:23-60``; missing = mean-impute after MAF, ``encoder.h:99-129``.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .ld_int8 import corr_from_dots, make_idot, scal_views
from .ld_xla import finalize_outputs


def plan_split_v2(rowmiss: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  seg_rows: int, m_pad: int, pad_to: int = 8) -> dict:
    """Host-side plan for :func:`split_corrections` (v2 segmented form)."""
    miss = np.flatnonzero(rowmiss).astype(np.int32)
    n_segs = max(1, -(-m_pad // seg_rows))
    cs = np.zeros(n_segs, np.int32)
    ce = np.zeros(n_segs, np.int32)
    xs = np.zeros(n_segs, np.int32)
    xe = np.zeros(n_segs, np.int32)
    for s in range(n_segs):
        s0, s1 = s * seg_rows, min((s + 1) * seg_rows, m_pad)
        cl = int(lo[s0:s1].min()) if s1 > s0 else m_pad
        ch = int(hi[s0:s1].max()) if s1 > s0 else -1
        cs[s] = np.searchsorted(miss, cl)
        ce[s] = np.searchsorted(miss, ch + 1)
        xs[s] = np.searchsorted(miss, s0)
        xe[s] = np.searchsorted(miss, s1)

    def pad_dim(count):
        p = int(count.max()) if len(count) else 0
        return max(pad_to, -(-p // pad_to) * pad_to)

    p_band = pad_dim(ce - cs)
    p_x = pad_dim(xe - xs)
    mm_pad = len(miss) + max(p_band, p_x)
    miss_idx = np.full(mm_pad, m_pad - 1, dtype=np.int32)
    miss_idx[: len(miss)] = miss
    return {"miss_idx": miss_idx, "cs": cs, "c_cnt": (ce - cs).astype(np.int32),
            "xs": xs, "x_cnt": (xe - xs).astype(np.int32),
            "p_band": p_band, "p_x": p_x, "mm_pad": mm_pad,
            "n_miss": len(miss), "n_segs": n_segs, "seg_rows": seg_rows}


@jax.jit
def compact_missing_rows(g_raw, miss_idx):
    """(mm_pad, N) int8 missing indicators for the contaminated rows only.

    Built from the RAW (pre-mask) codes, so callers can preprocess with
    ``materialize_m=False`` and never pay the full O(M·N) indicator
    matrix: rows gathered at ``miss_idx`` equal ``m[miss_idx]`` of the
    materializing path bitwise (padding's trailing ``m_pad - 1`` entries
    gather an arbitrary row — dead, masked by the plan's counts).
    """
    return (jnp.take(g_raw, miss_idx, axis=0) < 0).astype(jnp.int8)


@partial(jax.jit, static_argnames=("seg_rows", "n_segs", "p_band", "p_x",
                                   "n_samples", "dot_dtype"))
def split_corrections(g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss,
                      rsq_thr, own_hi, miss_idx, cs, c_cnt, xs, x_cnt,
                      annot=None, *,
                      seg_rows: int, n_segs: int, p_band: int, p_x: int,
                      n_samples: int, dot_dtype: str = "int8"):
    """δ-credit vectors for every pair with a contaminated member.

    Returns full-length (l2_δ f32, l2d_δ f32, wse_δ int32) to ADD to the
    clean pass's un-finalized credits.  ``m_c`` is the COMPACT
    (mm_pad, N) missing-indicator matrix for the contaminated rows in
    ``miss_idx`` order (:func:`compact_missing_rows`) — the kernel never
    touches a full-M indicator matrix.

    ``annot``: optional f32 (M_pad, p) annotation matrix.  Extends the
    return with (l2a_δ, l2da_δ) — (M_pad, p) per-annotation δ-credits to
    ADD to the clean symmetric annot scan's accumulators
    (``sym_scan_segment(annot=...)``): each corrected pair's δ weighted
    by its NEIGHBOR's annotation row, both directions (the same per-pair
    semantics as the clean scan's four skinny contractions,
    ``ldscalc.h:38-47`` weighted per annotation).

    ``own_hi``: pair-OWNERSHIP bound — a pair is credited only when its
    left member's index is < own_hi.  In-core callers pass m_pad (own
    everything); the STREAMING driver runs this kernel on each chunk's
    band in LOCAL coordinates with ``own_hi = chunk_rows``, so every
    global pair is corrected exactly once, by the chunk that owns its
    left member (the same ownership rule as the chunk pass itself); the
    returned band-length vectors then split into local credits and the
    forward tail exactly like the chunk pass outputs.
    """
    m_pad, n_pad_cols = g.shape
    n = jnp.float32(n_samples)
    n_padf = jnp.float32(n_pad_cols)
    inv_n2 = 1.0 / (n - 2.0)
    pad_const = n_padf - n            # smm for clean x = padding overlap
    idot = make_idot(dot_dtype)
    i32 = jnp.int32
    S = seg_rows

    g_c = jnp.take(g, miss_idx, axis=0)
    h_c = jnp.take(h, miss_idx, axis=0)
    scal_c = jnp.take(scal, miss_idx, axis=0)
    usable_c = jnp.take(usable, miss_idx)
    dom_ok_c = jnp.take(dom_ok, miss_idx)
    a_c = None if annot is None else jnp.take(annot, miss_idx, axis=0)

    def sl(v, at, size):
        return lax.dynamic_slice_in_dim(v, at, size)

    def adj(r):
        return r * r - (1.0 - r * r) * inv_n2

    def credit(full, at, vals):
        cur = lax.dynamic_slice_in_dim(full, at, vals.shape[0])
        return lax.dynamic_update_slice_in_dim(full, cur + vals, at, 0)

    def step(carry, s):
        l2_f, l2d_f, wse_f, l2_cf, l2d_cf, wse_cf = carry[:6]
        s0 = jnp.minimum(s * S, m_pad - S)      # clamped; overlap masked
        xidx = s0 + jnp.arange(S, dtype=i32)
        xvalid = (xidx >= s * S)[:, None]
        g_x = lax.dynamic_slice_in_dim(g, s0, S, axis=0)
        h_x = lax.dynamic_slice_in_dim(h, s0, S, axis=0)
        lo_x = sl(lo, s0, S)[:, None]
        hi_x = sl(hi, s0, S)[:, None]
        usable_x = sl(usable, s0, S)[:, None]
        dom_ok_x = sl(dom_ok, s0, S)[:, None]
        cln_x = ~sl(rowmiss, s0, S)[:, None]
        sc_x = scal_views(lax.dynamic_slice_in_dim(scal, s0, S, axis=0),
                          "col")

        c0 = cs[s]
        cidx = sl(miss_idx, c0, p_band)
        vc = (jnp.arange(p_band, dtype=i32) < c_cnt[s])[None, :]
        g_cc = lax.dynamic_slice_in_dim(g_c, c0, p_band, axis=0)
        m_cc = lax.dynamic_slice_in_dim(m_c, c0, p_band, axis=0)
        h_cc = lax.dynamic_slice_in_dim(h_c, c0, p_band, axis=0)
        sc_c = scal_views(
            lax.dynamic_slice_in_dim(scal_c, c0, p_band, axis=0), "row")
        usable_cc = sl(usable_c, c0, p_band)[None, :]
        dom_ok_cc = sl(dom_ok_c, c0, p_band)[None, :]

        # two big launches (each big operand read once per segment)
        cat3 = jnp.concatenate([g_cc, m_cc, h_cc], axis=0)
        a_t = idot(g_x, cat3)                       # (S, 3P)
        b_t = idot(h_x, cat3[: 2 * p_band])         # (S, 2P)
        # tiny compact product supplies the contaminated-x m-side dots
        x0 = xs[s]
        xcid = sl(miss_idx, x0, p_x)
        vx = (jnp.arange(p_x, dtype=i32) < x_cnt[s])[:, None]
        m_xc = lax.dynamic_slice_in_dim(m_c, x0, p_x, axis=0)
        d_t = idot(m_xc, cat3)                      # (p_x, 3P)
        locs = jnp.clip(xcid - s0, 0, S - 1)
        dz = jnp.where(vx & (xcid >= s0)[:, None]
                       & (xcid < s0 + S)[:, None], d_t, 0.0)
        d_full = jnp.zeros((S, 3 * p_band), jnp.float32).at[locs].add(dz)

        contam_x = ~cln_x
        P = p_band
        dots_x = {"sgg": a_t[:, :P], "sgm": a_t[:, P:2 * P],
                  "sgh": a_t[:, 2 * P:],
                  "shg": b_t[:, :P], "shm": b_t[:, P:2 * P],
                  "smg": d_full[:, :P],
                  "smm": jnp.where(contam_x, d_full[:, P:2 * P], pad_const),
                  "smh": d_full[:, 2 * P:]}
        rAx, rDax, rDbx = corr_from_dots(dots_x, sc_x, sc_c, n, n_padf,
                                         has_missing=True, symmetric=True)
        rA0, rDa0, rDb0 = corr_from_dots(dots_x, sc_x, sc_c, n, n_padf,
                                         has_missing=False, symmetric=True)

        # ORIENTATION selection for bitwise parity: pass 1 (and the
        # global engine) evaluate each pair's expressions with the pair's
        # LEFT member as i.  For entries where c < x, re-evaluate on the
        # role-swapped dots (every needed S value is already in the tiles
        # — e.g. sgh(c,x) = shg(x,c)) and select per pair, so the clean
        # baseline cancels pass 1's contribution bitwise and the
        # value-dependent WSE counter matches the global engine EXACTLY
        # instead of to-the-last-ulp-probabilistically (the f32 products
        # associate differently between the dom_a and dom_b branches).
        dots_s = {"sgg": dots_x["sgg"], "sgh": dots_x["shg"],
                  "shg": dots_x["sgh"], "sgm": dots_x["smg"],
                  "smg": dots_x["sgm"], "smm": dots_x["smm"],
                  "smh": dots_x["shm"], "shm": dots_x["smh"]}
        # the existing views already have the right broadcast shapes for
        # the swapped roles: i = c varies along columns ((1, P) row view),
        # j = x varies along rows ((S, 1) col view)
        rAxs, rDaxs, rDbxs = corr_from_dots(dots_s, sc_c, sc_x, n,
                                            n_padf, has_missing=True,
                                            symmetric=True)
        rA0s, rDa0s, rDb0s = corr_from_dots(dots_s, sc_c, sc_x, n,
                                            n_padf, has_missing=False,
                                            symmetric=True)
        swap = cidx[None, :] < xidx[:, None]        # c is the left member

        def sel(direct, swapped):
            return jnp.where(swap, swapped, direct)

        d_add = sel(adj(rAx) - adj(rA0), adj(rAxs) - adj(rA0s))
        # value crediting x = (add_x × resid_c): dom_a in the (x,c)
        # orientation, dom_b in the swapped (c,x) orientation
        aDax, aDa0 = sel(adj(rDax), adj(rDbxs)), sel(adj(rDa0), adj(rDb0s))
        # value crediting c = (add_c × resid_x): the mirror
        aDbx, aDb0 = sel(adj(rDbx), adj(rDaxs)), sel(adj(rDb0), adj(rDa0s))

        in_win = (cidx[None, :] >= lo_x) & (cidx[None, :] <= hi_x)
        own = jnp.minimum(xidx[:, None], cidx[None, :]) < own_hi
        pair = (in_win & usable_cc & usable_x & vc & xvalid & own
                & (cidx[None, :] != xidx[:, None]))
        dmA = pair & dom_ok_cc
        mirror = pair & cln_x
        dmB = mirror & dom_ok_x

        l2_f = credit(l2_f, s0, jnp.sum(d_add * pair, axis=1))
        l2d_f = credit(l2d_f, s0, jnp.sum((aDax - aDa0) * dmA, axis=1))
        wse_f = credit(
            wse_f, s0,
            jnp.sum(jnp.where(dmA, (aDax > rsq_thr).astype(i32)
                              - (aDa0 > rsq_thr).astype(i32), 0), axis=1))
        l2_cf = credit(l2_cf, c0, jnp.sum(d_add * mirror, axis=0))
        l2d_cf = credit(l2d_cf, c0, jnp.sum((aDbx - aDb0) * dmB, axis=0))
        wse_cf = credit(
            wse_cf, c0,
            jnp.sum(jnp.where(dmB, (aDbx > rsq_thr).astype(i32)
                              - (aDb0 > rsq_thr).astype(i32), 0), axis=0))
        if annot is None:
            return (l2_f, l2d_f, wse_f, l2_cf, l2d_cf, wse_cf), None

        # partitioned δ-credits: same four skinny contractions as the
        # clean scan's annot epilogue (sym_scan_segment), on the δ values
        # — precision 'highest', as there
        l2a_f, l2da_f, l2a_cf, l2da_cf = carry[6:]
        a_x = lax.dynamic_slice_in_dim(annot, s0, S, axis=0)       # (S, p)
        a_cc = lax.dynamic_slice_in_dim(a_c, c0, p_band, axis=0)   # (P, p)

        def credit2(full, at, vals):
            cur = lax.dynamic_slice_in_dim(full, at, vals.shape[0], axis=0)
            return lax.dynamic_update_slice_in_dim(full, cur + vals, at, 0)

        dotp = partial(jnp.dot, precision="highest",
                       preferred_element_type=jnp.float32)

        def dot_ct(tile, a_rows):          # (S, P)ᵀ · (S, p) -> (P, p)
            return lax.dot_general(tile, a_rows, (((0,), (0,)), ((), ())),
                                   precision="highest",
                                   preferred_element_type=jnp.float32)

        l2a_f = credit2(l2a_f, s0, dotp(d_add * pair, a_cc))
        l2da_f = credit2(l2da_f, s0, dotp((aDax - aDa0) * dmA, a_cc))
        l2a_cf = credit2(l2a_cf, c0, dot_ct(d_add * mirror, a_x))
        l2da_cf = credit2(l2da_cf, c0, dot_ct((aDbx - aDb0) * dmB, a_x))
        return (l2_f, l2d_f, wse_f, l2_cf, l2d_cf, wse_cf,
                l2a_f, l2da_f, l2a_cf, l2da_cf), None

    mm_pad = miss_idx.shape[0]
    zf = jnp.zeros(m_pad, jnp.float32)
    zi = jnp.zeros(m_pad, i32)
    init = (zf, zf, zi, jnp.zeros(mm_pad, jnp.float32),
            jnp.zeros(mm_pad, jnp.float32), jnp.zeros(mm_pad, i32))
    if annot is not None:
        p = annot.shape[1]
        init = init + (jnp.zeros((m_pad, p), jnp.float32),
                       jnp.zeros((m_pad, p), jnp.float32),
                       jnp.zeros((mm_pad, p), jnp.float32),
                       jnp.zeros((mm_pad, p), jnp.float32))
    carry, _ = lax.scan(step, init, jnp.arange(n_segs, dtype=i32))
    l2_f, l2d_f, wse_f, l2_cf, l2d_cf, wse_cf = carry[:6]
    l2_f = l2_f.at[miss_idx].add(l2_cf)
    l2d_f = l2d_f.at[miss_idx].add(l2d_cf)
    wse_f = wse_f.at[miss_idx].add(wse_cf)
    if annot is None:
        return l2_f, l2d_f, wse_f
    l2a_f, l2da_f, l2a_cf, l2da_cf = carry[6:]
    l2a_f = l2a_f.at[miss_idx].add(l2a_cf)
    l2da_f = l2da_f.at[miss_idx].add(l2da_cf)
    return l2_f, l2d_f, wse_f, l2a_f, l2da_f


#: default row-segment width for the corrections sweep (callers clamp to
#: the row count: ``min(SEG_ROWS_DEFAULT, m_pad)``)
SEG_ROWS_DEFAULT = 4096


def ld_scores_split(g, m_c, h, scal, lo_dev, hi_dev, usable, dom_ok,
                    add_sd_zero, rowmiss_dev, rsq_thr, plan, *,
                    block_size: int, right_k: int, n_samples: int,
                    dot_dtype: str = "int8"):
    """Finalized clean-scan + segmented-corrections composition.

    The convenience wrapper bench.py and the scripts use; the pipeline
    composes the same pieces itself so its progress path can dispatch
    the corrections ahead of the reported segments, and the streaming
    driver runs the corrections per chunk band instead.  ``m_c`` is the
    COMPACT contaminated-row indicator matrix
    (:func:`compact_missing_rows` on the raw codes) — no full-M
    indicator matrix exists anywhere on this path.
    """
    from .ld_int8 import sym_scan_segment  # noqa: PLC0415

    m_pad = g.shape[0]
    accs = sym_scan_segment(
        g, g, h, scal, lo_dev, hi_dev, usable, dom_ok, add_sd_zero,
        rsq_thr, jnp.int32(0), block_size=block_size, right_k=right_k,
        n_samples=n_samples, n_scan_blocks=m_pad // block_size,
        has_missing=False, dot_dtype=dot_dtype)
    l2_c, ws_c, poi_c, l2d_c, wsd_c, wse_c = accs
    l2_d, l2d_d, wse_d = split_corrections(
        g, m_c, h, scal, lo_dev, hi_dev, usable, dom_ok, rowmiss_dev,
        rsq_thr, jnp.int32(m_pad),
        jnp.asarray(plan["miss_idx"]), jnp.asarray(plan["cs"]),
        jnp.asarray(plan["c_cnt"]), jnp.asarray(plan["xs"]),
        jnp.asarray(plan["x_cnt"]), seg_rows=plan["seg_rows"],
        n_segs=plan["n_segs"], p_band=plan["p_band"], p_x=plan["p_x"],
        n_samples=n_samples, dot_dtype=dot_dtype)
    return finalize_outputs(l2_c + l2_d, l2d_c + l2d_d, ws_c, wsd_c,
                            wse_c + wse_d, poi_c, usable, add_sd_zero)
