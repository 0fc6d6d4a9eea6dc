"""End-to-end heritability estimation (the ``nldsc h2`` workload).

Mirrors ``nldsc/h2/routine.py``: read sumstats + LD scores, inner-join on
SNP, χ² = Z², drop SNPs with χ² ≥ chisq_max (dropped, not capped — quirk
Q11), then the two-stage additive+dominance regression.  Runs the JAX
regression in float64 (``jax.enable_x64``) on the host CPU by default: the
compute is O(M·p²), host-scale work that is never the bottleneck.
``on_device`` runs it in f32 on the default accelerator instead.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import numpy as np

import jax

from ..config import H2Config
from ..core.errors import NLDSCParameterError
from ..core.logging import log
from ..core.timing import elapsed_time
from ..io.ldscores import read_ld_scores
from ..io.sumstats import read_sumstats
from ..io.table import Table, inner_join
from .regression import hsq_estimate, hsq_estimate_onestage


def _cpu_device():
    """Context pinning to the CPU backend: the f64 regression is O(M·p²)
    host-scale work, not worth a device round trip."""
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        return contextlib.nullcontext()
    return jax.default_device(cpu)


def _regression_context(on_device: bool):
    """f64 on the host CPU, or f32 on the accelerator with every matmul
    at full f32 precision (a GPU's default f32 matmul is TF32)."""
    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(not on_device))
    stack.enter_context(jax.default_matmul_precision("highest") if on_device
                        else _cpu_device())
    return stack


def merge_ld_sumstats(sumstats, ld) -> Table:
    """Inner join on SNP in sumstats order (reference h2/utils.py:29-40)."""
    out = inner_join(Table.from_frame(sumstats), Table.from_frame(ld), "SNP")
    log.info("After merging with [reference panel LD/regression SNP LD], "
             "%d SNPs remain", len(out))
    if len(out) == 0:
        raise RuntimeError("No SNPs remain after merging sumstats with LD scores")
    return out


def prettify_summary(summary: dict) -> str:
    text = "\n========================= h2 summary =========================\n"
    text += (f"Additive h2: {summary['additive']['hsq']:.4f} "
             f"± std: {summary['additive']['hsq.std']:.4f}\n")
    text += (f"lambda GC: {summary['additive']['lambda_gc']:.4f}, "
             f"chi2 mean: {summary['additive']['chisq.mean']:.4f}\n")
    text += (f"Dominant h2: {summary['dominant']['hsq']:.4e} "
             f"± std: {summary['dominant']['hsq.std']:.4e}\n")
    if "residuals.mean" in summary["dominant"]:
        text += f"residuals mean: {summary['dominant']['residuals.mean']:.4e}\n"
    return text


def attempt_save(filename: str, summary: dict) -> None:
    """JSON save that refuses to overwrite (reference h2/utils.py:52-58)."""
    if Path(filename).is_file():
        raise FileExistsError("File already exists")
    with open(filename, "w") as f:
        json.dump(summary, f)


def _cols(x, n: int) -> np.ndarray:
    return np.asarray(x, dtype=np.float64).reshape(n, 1)


def estimate_h2_frames(sumstats, ld, M: int, MD: int, config: H2Config,
                       w_ld=None) -> dict:
    """Core h2 estimation on already-loaded tables (reference _estimate_h2).

    ``sumstats``, ``ld`` and ``w_ld`` are :class:`~nldsc_jax.io.table.Table`
    objects or pandas DataFrames.

    ``w_ld``: optional separate regression-weight LD scores (columns SNP,
    L2, L2D).  The reference hard-requires ``--w-ld == --ref-ld``
    (``nldsc/__main__.py:143-145``); passing a frame here lifts that
    restriction — weights use the w-ld scores wherever the reference used
    its (identical) w_ld, i.e. the additive stage weights on w-L2 and the
    dominance stage on w-L2D.
    """
    overall = merge_ld_sumstats(sumstats, ld)
    if w_ld is not None:
        w_frame = Table.from_frame(w_ld)[["SNP", "L2", "L2D"]].rename(
            {"L2": "_W_L2", "L2D": "_W_L2D"})
        overall = inner_join(overall, w_frame, "SNP")
        log.info("After merging with weight LD scores, %d SNPs remain",
                 len(overall))
        if len(overall) == 0:
            raise RuntimeError(
                "No SNPs remain after merging with weight LD scores")
    n = len(overall)
    chisq = _cols(overall["Z"] ** 2, n)

    chisq_max = config.chisq_max
    if chisq_max is None:
        chisq_max = max(0.001 * overall["N"].max(), 80)

    keep = np.ravel(chisq < chisq_max)
    overall = overall.take(keep)
    n_new = len(overall)
    log.info("Removed %d SNPs with chi^2 > %s (%d SNPs remain)",
             n - n_new, chisq_max, n_new)
    chisq = _cols(chisq[keep], n_new)

    if config.strategy not in ("one-stg", "two-stg"):
        raise NLDSCParameterError(
            "Unknown estimation strategy. Only `one-stg` and `two-stg` are allowed")

    ref_ld_add = _cols(overall["L2"], n_new)
    ref_ld_dom = _cols(overall["L2D"], n_new)
    w_add = (_cols(overall["_W_L2"], n_new) if w_ld is not None
             else ref_ld_add)
    w_dom = (_cols(overall["_W_L2D"], n_new) if w_ld is not None
             else ref_ld_dom)
    # on_device: f32 on the default accelerator — the regression code is
    # dtype-agnostic jnp, and the jackknife compensates its accumulation
    # in f32 (jackknife.py)
    with _regression_context(config.on_device):
        if config.strategy == "one-stg":
            # joint [L2, L2D] fit — the reference declares this strategy
            # but never implemented it (nldsc/h2/routine.py:43-44)
            return hsq_estimate_onestage(
                chisq=chisq, x_add=ref_ld_add, x_dom=ref_ld_dom,
                w_ld=w_add,
                N=_cols(overall["N"], n_new),
                M_add=np.array([[M]], dtype=np.float64),
                M_dom=np.array([[MD]], dtype=np.float64),
                n_blocks=config.n_blocks,
                intercept=config.intercept_h2,
                slow=config.slow_jackknife,
            )
        return hsq_estimate(
            chisq=chisq,
            x_add=ref_ld_add, w_add=w_add,
            x_dom=ref_ld_dom, w_dom=w_dom,
            N=_cols(overall["N"], n_new),
            M_add=np.array([[M]], dtype=np.float64),
            M_dom=np.array([[MD]], dtype=np.float64),
            n_blocks=config.n_blocks,
            intercept_add=config.intercept_h2,
            slow=config.slow_jackknife,
            two_step=config.two_step,
        )


def prettify_partitioned_summary(summary: dict) -> str:
    text = "\n==================== partitioned h2 summary ====================\n"
    text += (f"Total observed-scale h2: {summary['total']['hsq']:.4f} "
             f"± std: {summary['total']['hsq.std']:.4f}\n")
    text += (f"lambda GC: {summary['lambda_gc']:.4f}, "
             f"chi2 mean: {summary['chisq.mean']:.4f}, "
             f"intercept: {summary['intercept']:.4f}"
             f" ± {summary['intercept.std']:.4f}\n")
    text += f"{'annotation':<24}{'h2':>12}{'std':>12}{'prop':>10}{'enrich':>10}\n"
    for name, part in summary["annotations"].items():
        text += (f"{name:<24}{part['hsq']:>12.4f}{part['hsq.std']:>12.4f}"
                 f"{part['prop']:>10.4f}{part['enrichment']:>10.4f}\n")
    return text


@elapsed_time
def estimate_h2_partitioned(
    sumstats: str,
    ref_ld: str,
    w_ld: str,
    n_blocks: int = 200,
    intercept_h2: float | None = None,
    chisq_max: float | None = None,
    use_m: bool = False,
    save_to_json: str | None = None,
    on_device: bool = False,
) -> dict:
    """Partitioned (multi-annotation) heritability estimation.

    The reference declares partitioned LD support and raises
    NotImplementedError (SURVEY Q12, ``regressions.py:177-178``); here it
    is a first-class workload.  ``ref_ld`` points to a .L2 file/directory
    whose non-key columns are per-annotation LD scores with .M/.M_5_50
    sidecars carrying per-annotation SNP counts; ``w_ld`` supplies the
    (single-column) regression-weight LD scores and may differ from
    ``ref_ld`` (typically non-partitioned genome-wide scores).
    """
    from ..io.ldscores import read_ld_scores_partitioned  # noqa: PLC0415
    from .regression import hsq_partitioned  # noqa: PLC0415

    log.info("Reading GWAS summary statistics...")
    ss = read_sumstats(sumstats, alleles=False, dropna=True)

    log.info("Reading partitioned LD Scores...")
    ref, M_annot, annots = read_ld_scores_partitioned(ref_ld, use_m=use_m)

    if w_ld == ref_ld and annots == ["L2"]:
        w_frame = ref[["SNP", "L2"]].rename({"L2": "_WLD"})
    elif w_ld == ref_ld:
        # standard LDSC convention: weights = sum over annotations
        w_frame = Table({
            "SNP": ref["SNP"],
            "_WLD": np.sum([ref[a] for a in annots], axis=0)})
    else:
        w_scores, _, w_annots = read_ld_scores_partitioned(w_ld, use_m=use_m)
        if len(w_annots) != 1:
            raise NLDSCParameterError(
                "--w-ld must be a single-annotation LD score file")
        w_frame = w_scores[["SNP", w_annots[0]]].rename(
            {w_annots[0]: "_WLD"})

    overall = merge_ld_sumstats(ss, ref[["SNP", *annots]])
    overall = inner_join(overall, w_frame, "SNP")
    n = len(overall)
    if n == 0:
        raise RuntimeError("No SNPs remain after merging with weight LD scores")
    chisq = _cols(overall["Z"] ** 2, n)

    if chisq_max is None:
        chisq_max = max(0.001 * overall["N"].max(), 80)
    keep = np.ravel(chisq < chisq_max)
    overall = overall.take(keep)
    n_new = len(overall)
    log.info("Removed %d SNPs with chi^2 > %s (%d SNPs remain)",
             n - n_new, chisq_max, n_new)
    chisq = _cols(chisq[keep], n_new)

    x = np.column_stack([np.asarray(overall[a], dtype=np.float64)
                         for a in annots])
    w = _cols(overall["_WLD"], n_new)
    N = _cols(overall["N"], n_new)

    # on_device: f32 on the accelerator — the p = n_annot+1 normal-
    # equation solves run through the unrolled-Cholesky solve_posdef
    # (decomposition-free; jackknife.py), validated ≤1e-5 vs this f64
    # path in tests/test_h2_ondevice.py
    with _regression_context(on_device):
        res = hsq_partitioned(chisq, x, w, N, M_annot,
                              n_blocks=n_blocks, intercept=intercept_h2)

    cat = np.asarray(res.category.value, dtype=np.float64)
    cat_std = np.asarray(res.category.std, dtype=np.float64)
    prop = np.ravel(np.asarray(res.proportion.value, dtype=np.float64))
    prop_std = np.ravel(np.asarray(res.proportion.std, dtype=np.float64))
    enrich = np.asarray(res.enrichment, dtype=np.float64)
    m_prop = np.ravel(np.asarray(res.M_prop, dtype=np.float64))
    summary = {
        "total": {"hsq": res.total.value, "hsq.std": res.total.std},
        "annotations": {
            name: {
                "hsq": float(cat[i]),
                "hsq.std": float(cat_std[i]),
                "prop": float(prop[i]),
                "prop.std": float(prop_std[i]),
                "enrichment": float(enrich[i]),
                "M": float(np.ravel(M_annot)[i]),
                "M.prop": float(m_prop[i]),
            } for i, name in enumerate(annots)
        },
        "lambda_gc": res.lambda_gc,
        "chisq.mean": res.mean_chisq,
        "intercept": res.intercept.value,
        "intercept.std": res.intercept.std,
        "intercept.constrained": res.constrain_intercept,
    }
    print(prettify_partitioned_summary(summary))
    if save_to_json:
        attempt_save(save_to_json, summary)
    return summary


@elapsed_time
def estimate_h2(
    sumstats: str,
    ldscore: str,
    n_blocks: int = 200,
    intercept_h2: float | None = None,
    chisq_max: float | None = None,
    use_m: bool = False,
    two_step: float | None = None,
    strategy: str = "two-stg",
    save_to_json: str | None = None,
    samp_prev: float | None = None,
    pop_prev: float | None = None,
    w_ldscore: str | None = None,
    on_device: bool = False,
) -> dict:
    """Estimate additive + dominance heritability (reference estimate_h2).

    Returns the summary dict (and optionally saves it as JSON).
    ``samp_prev``/``pop_prev``: case/control prevalences — when both are
    given, liability-scale h² is added to the summary (the reference
    implements the conversion but never exposes it).
    ``w_ldscore``: optional separate regression-weight LD scores (the
    reference forbids ``--w-ld != --ref-ld``; see estimate_h2_frames).
    """
    log.info("Reading GWAS summary statistics...")
    ss = read_sumstats(sumstats, alleles=False, dropna=True)

    log.info("Reading LD Scores...")
    ld, M, MD = read_ld_scores(ldscore, use_m=use_m)

    w_frame = None
    if w_ldscore is not None and w_ldscore != ldscore:
        log.info("Reading weight LD Scores...")
        w_frame, _, _ = read_ld_scores(w_ldscore, use_m=use_m)

    if chisq_max is None:
        chisq_max = max(ss["N"].max() * 1e-3, 80)
    if two_step is None and intercept_h2 is None:
        two_step = 30

    config = H2Config(n_blocks=n_blocks, intercept_h2=intercept_h2,
                      chisq_max=chisq_max, two_step=two_step,
                      strategy=strategy, use_m=use_m, on_device=on_device)

    log.info("Estimating heritability...")
    result = estimate_h2_frames(ss, ld, M, MD, config, w_ld=w_frame)
    summary = result["summary"]

    if samp_prev is not None and pop_prev is not None:
        from .regression import h2_obs_to_liability  # noqa: PLC0415

        factor = h2_obs_to_liability(1.0, samp_prev, pop_prev)
        for part in ("additive", "dominant"):
            summary[part]["hsq.liability"] = summary[part]["hsq"] * factor
            summary[part]["hsq.liability.std"] = (
                summary[part]["hsq.std"] * factor)

    print(prettify_summary(summary))

    if save_to_json:
        attempt_save(save_to_json, summary)
    return summary
