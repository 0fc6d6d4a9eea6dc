"""Pure-NumPy float64 oracle for the LD-score pass.

This module *defines* the semantics every device path must reproduce.  It is a
clean-room float64 implementation of the reference behavior (SURVEY §2.3
quirks Q1-Q7; reference files ``encoder.h``, ``tools.h``, ``ldscalc.h``,
``stream.h``):

* additive code counts A2 alleles: hom-A1=0, het=1, hom-A2=2; dominant code
  is (0, 2, 2)                                       [encoder.h:34-40]
* MAF = folded mean/2, computed from non-missing only; a SNP is dropped when
  ``maf <= maf_thr``                                  [encoder.h:99-122]
* missing genotypes are mean-imputed in both encodings after MAF
                                                      [encoder.h:124-129]
* dominance residuals = d - slope*a with slope from 1-D OLS (no intercept
  subtraction in the residual; the later standardization removes the mean)
                                                      [tools.h:54-68]
* standardization uses population variance (divide by n) [tools.h:70-85]
* pair statistic: adjusted r² = 1 - (1-r²)(n-1)/(n-2), r = dot/n over
  standardized vectors                                [tools.h:87-92]
* window: |pos_j - pos_i| <= ld_wind, *inclusive*; negative position is a
  "skip this SNP" sentinel                            [tools.h:15-23,41-49]
* l2 starts at 1.0 (self), l2d at 0.0; neighbor sums exclude self
                                                      [ldscalc.h:27-28]
* dominance pair = (pivot additive) x (neighbor dominance-residual); the
  neighbor enters only if its raw residual sd > std_thr; ``wse`` counts
  pairs with dominance adjusted-r² > rsq_thr          [ldscalc.h:38-47]
* outputs for skipped SNPs: l2/l2d = NaN, window counters = -1; MAF is NaN
  only for position-skipped SNPs (it IS recorded for MAF-dropped ones);
  residual sd is NaN for any unusable SNP             [ldscalc.h:16-21, encoder.h:47-48]

Complexity is O(M·W·N); fine for test-scale data (M ≤ a few thousand).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PreprocessedSNPs:
    """Per-SNP preprocessing results in float64."""

    add_std: np.ndarray      # (M, N) standardized additive;    0-rows where unusable
    res_std: np.ndarray      # (M, N) standardized dom residual; 0-rows where unusable
    maf: np.ndarray          # (M,)  folded MAF; NaN where position-skipped
    residuals_sd: np.ndarray  # (M,) raw residual population sd; NaN where unusable
    usable: np.ndarray       # (M,)  bool: position ok AND maf > maf_thr
    add_sd_zero: np.ndarray  # (M,)  bool: usable but additive sd == 0 ("poison")


def preprocess(genotypes: np.ndarray, positions: np.ndarray,
               maf_thr: float) -> PreprocessedSNPs:
    """Decode/impute/standardize/residualize every SNP (float64)."""
    codes = np.asarray(genotypes)
    m, n = codes.shape
    positions = np.asarray(positions, dtype=np.float64)

    add_std = np.zeros((m, n))
    res_std = np.zeros((m, n))
    maf = np.full(m, np.nan)
    residuals_sd = np.full(m, np.nan)
    usable = np.zeros(m, dtype=bool)
    add_sd_zero = np.zeros(m, dtype=bool)

    for i in range(m):
        if positions[i] < 0:
            continue  # position sentinel: .bed row skipped, MAF not recorded
        g = codes[i].astype(np.float64)
        miss = codes[i] < 0
        valid = ~miss
        n_valid = int(valid.sum())
        a = np.where(miss, 0.0, g)
        d = np.where(miss, 0.0, np.minimum(g, 1.0) * 2.0)  # (0,1,2)->(0,2,2)
        with np.errstate(invalid="ignore", divide="ignore"):
            # all-missing SNP: 0/0 = NaN mean is the reference behavior
            add_mean = a.sum() / n_valid
            dom_mean = d.sum() / n_valid

        f2 = add_mean / 2.0
        maf[i] = f2 if f2 < 0.5 else 1.0 - f2
        if maf[i] <= maf_thr:
            continue  # MAF-dropped: maf recorded, everything else unusable

        a = np.where(miss, add_mean, g)
        d = np.where(miss, dom_mean, np.minimum(g, 1.0) * 2.0)

        # 1-D OLS slope of d on a (tools.h:54-68)
        a_mean, d_mean = a.mean(), d.mean()
        denom = (a @ a) / n - a_mean * a_mean
        slope = ((a @ d) / n - a_mean * d_mean) / denom if denom != 0 else np.nan
        r = d - slope * a

        a_sd = np.sqrt(((a - a_mean) ** 2).sum() / n)
        r_mean = r.mean()
        r_sd = np.sqrt(((r - r_mean) ** 2).sum() / n)

        usable[i] = True
        residuals_sd[i] = r_sd
        if a_sd == 0 or not np.isfinite(a_sd):
            add_sd_zero[i] = True  # reference divides by 0 -> NaN poison
        else:
            add_std[i] = (a - a_mean) / a_sd
        if r_sd > 0 and np.isfinite(r_sd):
            res_std[i] = (r - r_mean) / r_sd
        # r_sd == 0 rows stay 0; they can never pass the std_thr filter

    return PreprocessedSNPs(add_std, res_std, maf, residuals_sd, usable, add_sd_zero)


def adjusted_r2(x: np.ndarray, y: np.ndarray) -> float:
    """1 - (1-r²)(n-1)/(n-2) with r = dot/n on standardized vectors."""
    n = x.shape[-1]
    r = (x @ y) / n
    return 1.0 - (1.0 - r * r) * (n - 1) / (n - 2)


def _pivot_dots(pre: PreprocessedSNPs, rows) -> tuple | None:
    """Dot products of every SNP's standardized additive and dominance
    vectors with the additive vectors of the pivot ``rows``: two (M, R)
    matrices from one matrix product each, so a sample of pivots costs
    two GEMMs instead of a gather per pivot.  None when ``rows`` is None
    (every pivot; the per-pivot products below are used)."""
    if rows is None:
        return None
    y = pre.add_std[rows]
    return pre.add_std @ y.T, pre.res_std @ y.T


def _dots(pre: PreprocessedSNPs, dots, k: int, i: int, idx, dom: bool):
    if dots is not None:
        return dots[1 if dom else 0][idx, k]
    return (pre.res_std if dom else pre.add_std)[idx] @ pre.add_std[i]


def oracle_ld(genotypes: np.ndarray, positions: np.ndarray, ld_wind: float,
              maf_thr: float, std_thr: float, rsq_thr: float,
              rows=None) -> dict:
    """Brute-force LD scores with exact reference semantics.

    Parameters
    ----------
    genotypes : int8 (M, N), codes {0,1,2,-1}
    positions : float64 (M,) — BP or cM; negative = skip sentinel
    ld_wind, maf_thr, std_thr, rsq_thr : scalars (see module docstring)
    rows : optional pivot row indices; only these rows are computed and
        the others keep the undefined sentinels (NaN / -1)

    Returns
    -------
    dict with keys l2, l2d, maf, residuals_std (float64 arrays, NaN where
    undefined) and l2_ws, l2d_ws, l2d_wse (int arrays, -1 where undefined).
    """
    codes = np.asarray(genotypes)
    m, n = codes.shape
    positions = np.asarray(positions, dtype=np.float64)
    pre = preprocess(codes, positions, maf_thr)

    l2 = np.full(m, np.nan)
    l2d = np.full(m, np.nan)
    ws = np.full(m, -1, dtype=np.int64)
    wsd = np.full(m, -1, dtype=np.int64)
    wse = np.full(m, -1, dtype=np.int64)

    adj_c = (n - 1) / (n - 2)
    dots = _pivot_dots(pre, rows)
    for k, i in enumerate(range(m) if rows is None else rows):
        if not pre.usable[i]:
            continue
        in_win = np.abs(positions - positions[i]) <= ld_wind
        nbr = in_win & pre.usable
        nbr[i] = False
        idx = np.flatnonzero(nbr)
        ws[i] = len(idx)

        # Additive sum. A zero-add-sd SNP standardizes to a NaN vector in the
        # reference, so it poisons the additive sum of every pair it joins —
        # whether it is the pivot or a neighbor (ldscalc.h:38).
        if pre.add_sd_zero[i] or np.any(pre.add_sd_zero[idx]):
            l2[i] = np.nan
        else:
            r_add = _dots(pre, dots, k, i, idx, dom=False) / n
            l2[i] = 1.0 + (1.0 - (1.0 - r_add**2) * adj_c).sum()

        # Dominance sum: a zero-add-sd *neighbor* has NaN residual sd and is
        # already excluded by the std filter (NaN > thr is false), so only a
        # zero-add-sd *pivot* poisons l2d — and only if >= 1 neighbor passes
        # the filter (otherwise the 0.0 init survives, ldscalc.h:28).
        dom_sel = pre.residuals_sd[idx] > std_thr  # NaN-safe: NaN -> False
        dom_idx = idx[dom_sel]
        wsd[i] = len(dom_idx)
        if pre.add_sd_zero[i]:
            l2d[i] = np.nan if len(dom_idx) > 0 else 0.0
            wse[i] = 0  # NaN > rsq_thr is false in the reference comparison
        else:
            r_dom = _dots(pre, dots, k, i, dom_idx, dom=True) / n
            dom_terms = 1.0 - (1.0 - r_dom**2) * adj_c
            l2d[i] = dom_terms.sum()
            wse[i] = int((dom_terms > rsq_thr).sum())

    return {
        "l2": l2, "l2d": l2d, "maf": pre.maf,
        "residuals_std": pre.residuals_sd,
        "l2_ws": ws, "l2d_ws": wsd, "l2d_wse": wse,
    }


def oracle_ld_annot(genotypes: np.ndarray, positions: np.ndarray,
                    ld_wind: float, maf_thr: float, std_thr: float,
                    annot: np.ndarray, rows=None) -> dict:
    """Brute-force PARTITIONED LD scores (float64 truth for the annot engine).

    Per-pair semantics identical to :func:`oracle_ld`; each neighbor's
    adjusted r² is weighted by its annotation row, and the self term
    contributes ``annot[i, k] * 1.0`` to ``l2_annot[i, k]`` (dominance self
    term is 0).  ``annot``: float64 (M, p), continuous values allowed.

    ``rows``: optional pivot row indices, as in :func:`oracle_ld`.

    Returns dict with ``l2_annot`` and ``l2d_annot`` (M, p) float64, NaN
    where the unpartitioned scores are NaN.
    """
    codes = np.asarray(genotypes)
    m, n = codes.shape
    annot = np.asarray(annot, dtype=np.float64)
    positions = np.asarray(positions, dtype=np.float64)
    pre = preprocess(codes, positions, maf_thr)
    p = annot.shape[1]
    l2_a = np.full((m, p), np.nan)
    l2d_a = np.full((m, p), np.nan)
    adj_c = (n - 1) / (n - 2)
    dots = _pivot_dots(pre, rows)
    for k, i in enumerate(range(m) if rows is None else rows):
        if not pre.usable[i]:
            continue
        in_win = np.abs(positions - positions[i]) <= ld_wind
        nbr = in_win & pre.usable
        nbr[i] = False
        idx = np.flatnonzero(nbr)
        if not (pre.add_sd_zero[i] or np.any(pre.add_sd_zero[idx])):
            r_add = _dots(pre, dots, k, i, idx, dom=False) / n
            terms = 1.0 - (1.0 - r_add**2) * adj_c
            l2_a[i] = annot[i] + terms @ annot[idx]
        dom_sel = pre.residuals_sd[idx] > std_thr
        dom_idx = idx[dom_sel]
        if pre.add_sd_zero[i]:
            l2d_a[i] = np.nan if len(dom_idx) > 0 else 0.0
        else:
            r_dom = _dots(pre, dots, k, i, dom_idx, dom=True) / n
            dom_terms = 1.0 - (1.0 - r_dom**2) * adj_c
            l2d_a[i] = dom_terms @ annot[dom_idx]
    return {"l2_annot": l2_a, "l2d_annot": l2d_a}
