"""LD-score regression estimators (reference: ``nldsc/h2/regressions.py``).

Clean-room implementation of the Bulik-Sullivan/Finucane LD-score regression
with the nldsc dominance extension, restructured functionally: one driver
(:func:`ldscore_regression`) parameterized by a null intercept and a weights
function, plus thin additive/dominant front-ends.

Behavioral parity notes (mirroring the reference's *actual* runtime
behavior, SURVEY §2.3-Q11/Q12):

* regressors are pre-scaled by ``N / N̄`` (regressions.py:166-167)
* ``hsq`` inside weight updates is ``M·coef / (N̄ − 1)`` (regressions.py:437)
* the two-step estimator fits a free-intercept model on SNPs with
  ``χ² < two_step``, then a constrained model on all SNPs, and combines the
  jackknives with the correction factor ``c`` (regressions.py:179-209,325-348)
* step-1 weight updates read the *N-scaled* LD column (they receive the
  masked design matrix), step-2 and plain-path updates read the raw column
  (they receive ``x_tot``) — an asymmetry the reference has and we keep
* the dominance stage regresses additive-model residuals
  ``reweigh(χ² − L2·N̄·coef − intercept, w_final_additive)`` with intercept
  constrained to 0 and the ``+1e-10``-guarded weight function; it DOES run
  the 2 IRWLS weight iterations (the reference's ``additive_weights``
  shortcut is dead code — commented out at regressions.py:550-551)
* weights clip ``hsq∈[0,1]``, ``ld,w_ld ≥ 1`` (regressions.py:496-498)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..core.logging import log
from . import irwls
from . import jackknife as jk


@dataclass
class Coefficient:
    value: object
    cov: object = None
    std: object = None


@dataclass
class HsqResult:
    jknife: jk.JackknifeResult
    coef: Coefficient          # per-annotation coefficient (value: (p,))
    category: Coefficient      # per-category h2
    total: Coefficient         # total h2 (floats)
    proportion: Coefficient
    enrichment: jnp.ndarray
    M_prop: jnp.ndarray
    intercept: Coefficient
    constrain_intercept: bool
    mean_chisq: float
    lambda_gc: float
    ratio: Coefficient | None
    tot_delete_values: jnp.ndarray
    weights_checkpoint: jnp.ndarray  # final IRWLS weights (pre-sqrt)


def h2_obs_to_liability(h2_obs: float, P: float, K: float) -> float:
    """Observed-scale h² in an ascertained sample -> liability-scale h²
    (reference regressions.py:30-58).

    P: sample prevalence; K: population prevalence (both in (0,1);
    NaN/NaN passes h2_obs through unchanged).
    """
    from scipy import stats as ss  # noqa: PLC0415

    if np.isnan(P) and np.isnan(K):
        return h2_obs
    if not 0 < K < 1:
        raise ValueError("K must be in the range (0, 1)")
    if not 0 < P < 1:
        raise ValueError("P must be in the range (0, 1)")
    thresh = ss.norm.isf(K)
    conversion = K**2 * (1 - K)**2 / (P * (1 - P) * ss.norm.pdf(thresh)**2)
    return h2_obs * conversion


@jax.jit
def weights_additive(ld, w_ld, N, M_tot, hsq, intercept=None):
    """Heteroskedasticity × overcounting weights (regressions.py:465-503).

    Jitted (one compiled program instead of ~10 eager dispatches — the
    on-device path pays a compile per eager op; a handful of
    distinct python-float intercept values just means a few traces)."""
    if intercept is None:
        intercept = 1.0
    hsq = jnp.clip(hsq, 0.0, 1.0)
    ld = jnp.maximum(ld, 1.0)
    w_ld = jnp.maximum(w_ld, 1.0)
    c = hsq * (N - 1) / M_tot
    het_w = 1.0 / (2.0 * jnp.square(intercept + c * ld))
    # f32 (on-device) guard: on DEGENERATE input (near-constant LD, the
    # design matrix collinear with the intercept) the step-1 coefficient
    # blows up, the squared term overflows, het_w underflows and — XLA
    # flushes f32 subnormals to zero — the final weight comes out
    # exactly 0, which `reweigh` correctly rejects.  Floor the FINAL
    # weight at the dtype's smallest normal (the floor must sit after
    # the /w_ld: flooring het_w alone still left tiny/w_ld subnormal →
    # FTZ zero for half the rows — measured on the r5 UKB-N run).  In
    # f64 (the reference-parity path) the floor is ~1e-308 and can
    # never bind on data the reference itself accepts, so parity is
    # untouched; in f32 the run proceeds and the jackknife std honestly
    # reports the degeneracy.
    return jnp.maximum(het_w / w_ld, jnp.finfo(het_w.dtype).tiny)


@jax.jit
def weights_dominant(ld, w_ld, N, M_tot, hsq, intercept=None):
    """Dominance weights: +1e-10 guard for the zero intercept
    (regressions.py:557-595)."""
    if intercept is None:
        intercept = 1.0
    hsq = jnp.clip(hsq, 0.0, 1.0)
    ld = jnp.maximum(ld, 1.0)
    w_ld = jnp.maximum(w_ld, 1.0)
    c = hsq * (N - 1) / M_tot
    het_w = 1.0 / (2.0 * jnp.square(intercept + c * ld) + 1e-10)
    # same f32 degenerate-input guard as weights_additive (see there)
    return jnp.maximum(het_w / w_ld, jnp.finfo(het_w.dtype).tiny)


@jax.jit
def _aggregate(y, x_tot, N, M_tot, intercept):
    """Initial h² guess (regressions.py:255-261)."""
    return M_tot * (jnp.mean(y) - intercept) / jnp.mean(x_tot * N)


def _remap_separators(separators: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Map step-1 (masked-subset) separators to full-data indices
    (update_stdparators, regressions.py:61-68)."""
    maplist = np.flatnonzero(mask)
    inner = maplist[separators[1:-1]]
    return np.hstack([0, inner, len(mask)])


@partial(jax.jit, static_argnames=("con",))
def _prep_design(y, x, M, N, con):
    """Regression preamble as one compiled program (each eager op is a
    separate compile on the on-device path)."""
    M_tot = jnp.sum(M)
    x_tot_raw = jnp.sum(x, axis=1).reshape(x.shape[0], 1)
    N_mean = jnp.mean(N)
    x_scaled = (N * x) / N_mean
    if not con:
        ones = jnp.ones((x.shape[0], 1), x.dtype)
        return (M_tot, x_tot_raw, N_mean, x_scaled,
                jnp.concatenate([x_scaled, ones], axis=1),
                jnp.concatenate([x_tot_raw, ones], axis=1))
    return M_tot, x_tot_raw, N_mean, x_scaled, x_scaled, x_tot_raw


@jax.jit
def _extract_core(est, jk_cov, delete_values, M, N_mean):
    """Coefficient/category/proportion-input extraction as one compiled
    program (regressions.py:226-323 math, unchanged)."""
    p = M.shape[1]
    coef_val = est[0, :p] / N_mean
    coef_cov = jk_cov[:p, :p] / N_mean**2
    coef_std = jnp.sqrt(jnp.diag(coef_cov))
    cat_val = (M * coef_val).reshape(p)
    cat_cov = (M.T @ M) * coef_cov
    cat_std = jnp.sqrt(jnp.diag(cat_cov))
    tot_val = jnp.sum(cat_val)
    tot_cov = jnp.sum(cat_cov)
    nb = delete_values.shape[0]
    numer_delete = (M * delete_values[:, :p]) / N_mean
    denom_delete = (jnp.sum(numer_delete, axis=1).reshape(nb, 1)
                    @ jnp.ones((1, p)))
    tot_delete_values = (delete_values[:, :p] @ M.T) / N_mean
    return (coef_val, coef_cov, coef_std, cat_val, cat_cov, cat_std,
            tot_val, tot_cov, numer_delete, denom_delete,
            tot_delete_values)


def _check_shapes(y, x, w, N, M):
    n, p = x.shape
    for name, a in (("y", y), ("w", w), ("N", N)):
        if a.shape != (n, 1):
            raise ValueError(
                f"{name} must have shape ({n}, 1), got {a.shape}")
    if M.shape != (1, p):
        raise ValueError(f"M must have shape (1, {p}), got {M.shape}")
    return n, p


def ldscore_regression(
    y, x, w, N, M,
    n_blocks: int,
    null_intercept: float,
    weights_fn,
    intercept: float | None = None,
    slow: bool = False,
    two_step: float | None = None,
) -> HsqResult:
    """Run one LD-score regression (additive or dominance partition)."""
    y, x, w, N, M = (jnp.asarray(a) for a in (y, x, w, N, M))
    n_snp, n_annot = _check_shapes(y, x, w, N, M)
    constrain = intercept is not None

    (M_tot, x_tot_raw, N_mean, x_scaled, x_design,
     x_tot_func) = _prep_design(y, x, M, N, con=constrain)
    yp = y if not constrain else y - intercept

    agg_intercept = intercept if constrain else null_intercept
    tot_agg = _aggregate(y, x_tot_raw, N, M_tot, agg_intercept)

    checkpoint = {}
    initial_w = weights_fn(x_tot_raw, w, N, M_tot, tot_agg,
                           intercept if constrain else null_intercept)
    checkpoint["w"] = initial_w

    if two_step is not None and constrain:
        raise ValueError("two-step is not compatible with constrain_intercept.")
    if two_step is not None and n_annot > 1:
        raise ValueError("two-step not compatible with partitioned LD Score yet.")

    if two_step is not None:
        mask = np.asarray(y < two_step).ravel()
        n1 = int(mask.sum())
        midx = jnp.asarray(np.flatnonzero(mask))
        x1 = x_design[midx]
        yp1, w1, N1, iw1 = (a[midx].reshape(n1, 1) for a in (yp, w, N, initial_w))

        def update1(coef):
            hsq = M_tot * coef[0, 0] / (N_mean - 1.0)
            icept = coef[1, 0]
            ld = x1[:, 0].reshape(n1, 1)      # N-scaled column (see module doc)
            new_w = weights_fn(ld, w1, N1, M_tot, hsq, icept)
            checkpoint["w"] = new_w
            return new_w

        step1 = irwls.irwls(x1, yp1, update1, n_blocks, w=iw1, slow=slow)
        step1_int = step1.est[0, n_annot]

        yp = yp - step1_int
        x_design = x_design[:, :n_annot]

        def update2(coef):
            hsq = M_tot * coef[0, 0] / (N_mean - 1.0)
            ld = x_tot_raw[:, 0].reshape(n_snp, 1)
            new_w = weights_fn(ld, w, N, M_tot, hsq, step1_int)
            checkpoint["w"] = new_w
            return new_w

        separators = _remap_separators(step1.separators, mask)
        step2 = irwls.irwls(x_design, yp, update2, n_blocks, w=initial_w,
                            slow=slow, separators=separators)

        c = jnp.sum(initial_w * x_design) / jnp.sum(initial_w * jnp.square(x_design))
        jknife = _combine_twostep(step1, step2, c, n_annot)
    else:
        def update(coef):
            hsq = M_tot * coef[0, 0] / (N_mean - 1.0)
            icept = coef[1, 0] if not constrain else intercept
            ld = x_tot_func[:, 0].reshape(n_snp, 1)
            new_w = weights_fn(ld, w, N, M_tot, hsq, icept)
            checkpoint["w"] = new_w
            return new_w

        jknife = irwls.irwls(x_design, yp, update, n_blocks, w=initial_w,
                             slow=slow)

    # ---- extraction (regressions.py:226-323), one compiled program ----
    p = n_annot
    (coef_val, coef_cov, coef_std, cat_val, cat_cov, cat_std, tot_val_a,
     tot_cov_a, numer_delete, denom_delete,
     tot_delete_values) = _extract_core(
        jknife.est, jknife.jk_cov, jknife.delete_values, M, N_mean)
    coef = Coefficient(coef_val, coef_cov, coef_std)
    category = Coefficient(cat_val, cat_cov, cat_std)
    tot_val = float(tot_val_a)
    tot_cov = float(tot_cov_a)
    total = Coefficient(tot_val, tot_cov, float(np.sqrt(tot_cov)))

    prop = jk.ratio_jackknife((cat_val / tot_val).reshape(1, p),
                              numer_delete, denom_delete)
    proportion = Coefficient(prop.est, prop.jk_cov, prop.jk_std)

    M_prop = M / M_tot
    enrichment = (cat_val / M.reshape(p)) / (tot_val / M_tot)

    if not constrain:
        icept_out = Coefficient(float(jknife.est[0, p]),
                                std=float(jknife.jk_std[0, p]))
    else:
        icept_out = Coefficient(float(intercept), std=float("nan"))

    mean_chisq = float(jnp.mean(y))
    lambda_gc = float(jnp.median(y) / 0.4549)
    ratio = None
    if not constrain:
        if mean_chisq > 1.0:
            ratio = Coefficient(
                (icept_out.value - 1.0) / (mean_chisq - 1.0),
                std=icept_out.std / (mean_chisq - 1.0))
        else:
            ratio = Coefficient(float("nan"), std=float("nan"))

    return HsqResult(
        jknife=jknife, coef=coef, category=category, total=total,
        proportion=proportion, enrichment=enrichment, M_prop=M_prop,
        intercept=icept_out, constrain_intercept=constrain,
        mean_chisq=mean_chisq, lambda_gc=lambda_gc, ratio=ratio,
        tot_delete_values=tot_delete_values,
        weights_checkpoint=checkpoint["w"],
    )


def _combine_twostep(step1: jk.JackknifeResult, step2: jk.JackknifeResult,
                     c, n_annot: int) -> jk.JackknifeResult:
    """Combine free- and constrained-intercept jackknives
    (regressions.py:325-348)."""
    nb = step1.delete_values.shape[0]
    step1_int = step1.est[0, n_annot]
    est = jnp.concatenate([step2.est, step1_int.reshape(1, 1)], axis=1)
    dv_int = step1.delete_values[:, n_annot].reshape(nb, 1)
    dv_coef = step2.delete_values - c * (dv_int - step1_int)
    delete = jnp.concatenate([dv_coef, dv_int], axis=1)
    pseudo = jk.delete_values_to_pseudovalues(delete, est)
    jk_est, jk_var, jk_std, jk_cov = jk.jackknife_moments(pseudo)
    return jk.JackknifeResult(est=est, jk_est=jk_est, jk_var=jk_var,
                              jk_std=jk_std, jk_cov=jk_cov,
                              delete_values=delete,
                              separators=step2.separators)


def hsq_additive(chisq, x, w_ld, N, M, n_blocks=200, intercept=None,
                 slow=False, two_step=None) -> HsqResult:
    """Additive partition (reference HSQAdditive, null intercept 1.0)."""
    return ldscore_regression(
        chisq, x, w_ld, N, M, n_blocks,
        null_intercept=1.0, weights_fn=weights_additive,
        intercept=intercept, slow=slow, two_step=two_step)


def hsq_dominant(chisq, x_dom, w_dom, w_add_ld, N, M_dom, n_blocks,
                 slow, add_result: HsqResult) -> HsqResult:
    """Dominance partition regressing additive-model residuals
    (reference HSQDominant, regressions.py:524-554)."""
    chisq, w_add_ld, N = (jnp.asarray(a) for a in (chisq, w_add_ld, N))
    beta = jnp.mean(N) * add_result.coef.value[0]
    icept = add_result.intercept.value
    weights = add_result.weights_checkpoint
    residuals = irwls.reweigh(chisq - w_add_ld * beta - icept, weights)
    return ldscore_regression(
        residuals, x_dom, w_dom, N, M_dom, n_blocks,
        null_intercept=0.0, weights_fn=weights_dominant,
        intercept=0.0, slow=slow, two_step=None)


def hsq_partitioned(chisq, x_annot, w_ld, N, M_annot, n_blocks=200,
                    intercept=None, slow=False) -> HsqResult:
    """Partitioned (multi-annotation) additive h² regression.

    A capability the reference declares but never exposes (SURVEY Q12:
    'partitioned LD declared but unimplemented' at its CLI): the underlying
    regression is annotation-generic and matches the reference's internal
    p>1 path exactly.  Two-step is not supported for p>1 (both
    implementations raise), so the intercept is either free or constrained.

    Parameters
    ----------
    chisq : (n, 1); x_annot : (n, p) per-annotation LD scores;
    w_ld : (n, 1) regression-weight LD scores; M_annot : (1, p) SNP counts.

    Returns an :class:`HsqResult`; ``category``/``proportion``/
    ``enrichment`` carry the per-annotation partition.
    """
    return ldscore_regression(
        chisq, x_annot, w_ld, N, M_annot, n_blocks,
        null_intercept=1.0, weights_fn=weights_additive,
        intercept=intercept, slow=slow, two_step=None)


def hsq_estimate_onestage(chisq, x_add, x_dom, w_ld, N, M_add, M_dom,
                          n_blocks=200, intercept=None, slow=False) -> dict:
    """Joint single-stage estimator (the reference's declared-but-absent
    ``one-stg`` strategy, ``nldsc/h2/routine.py:43-44``).

    Regresses χ² on [L2, L2D] **simultaneously** as a 2-annotation
    partitioned model with one shared intercept, instead of the two-stage
    additive-fit-then-residual-regression.  Standard errors for both
    partitions come from one joint block jackknife, so the dominance SE
    correctly accounts for its covariance with the additive estimate
    (which the sequential estimator's plug-in residuals ignore).
    Two-step is unavailable (p>1); the intercept is free or constrained.
    """
    chisq, x_add, x_dom = (jnp.asarray(a) for a in (chisq, x_add, x_dom))
    n = chisq.shape[0]
    x = jnp.concatenate([x_add.reshape(n, 1), x_dom.reshape(n, 1)], axis=1)
    M_annot = jnp.concatenate(
        [jnp.asarray(M_add).reshape(1, 1), jnp.asarray(M_dom).reshape(1, 1)],
        axis=1)
    log.info("Estimating additive + non-additive heritability jointly...")
    joint = hsq_partitioned(chisq, x, w_ld, N, M_annot, n_blocks=n_blocks,
                            intercept=intercept, slow=slow)
    cat = np.asarray(joint.category.value, dtype=np.float64)
    cat_std = np.asarray(joint.category.std, dtype=np.float64)
    summary = {
        "additive": {
            "hsq": float(cat[0]),
            "hsq.std": float(cat_std[0]),
            "lambda_gc": joint.lambda_gc,
            "chisq.mean": joint.mean_chisq,
            "intercept": joint.intercept.value,
            "intercept.std": joint.intercept.std,
            "intercept.constrained": joint.constrain_intercept,
        },
        "dominant": {
            "hsq": float(cat[1]),
            "hsq.std": float(cat_std[1]),
            "intercept": joint.intercept.value,
            "intercept.std": joint.intercept.std,
        },
        "strategy": "one-stg",
    }
    return {"summary": summary, "joint": joint}


def hsq_estimate(chisq, x_add, w_add, x_dom, w_dom, N, M_add, M_dom,
                 n_blocks=200, intercept_add=None, slow=False,
                 two_step=None) -> dict:
    """Additive then dominance estimation + summary dict
    (reference HSQEstimator, regressions.py:598-641)."""
    log.info("Estimating additive heritability...")
    additive = hsq_additive(chisq, x_add, w_add, N, M_add, n_blocks,
                            intercept_add, slow, two_step)
    log.info("Estimating non-additive heritability...")
    dominant = hsq_dominant(chisq, x_dom, w_dom, w_add, N, M_dom,
                            n_blocks, slow, additive)
    summary = {
        "additive": {
            "hsq": additive.total.value,
            "hsq.std": additive.total.std,
            "lambda_gc": additive.lambda_gc,
            "chisq.mean": additive.mean_chisq,
            "intercept": additive.intercept.value,
            "intercept.std": additive.intercept.std,
            "intercept.constrained": additive.constrain_intercept,
        },
        "dominant": {
            "hsq": dominant.total.value,
            "hsq.std": dominant.total.std,
            "residuals.mean": dominant.mean_chisq,
            "intercept": dominant.intercept.value,
            # parity quirk Q12: the reference reports the ADDITIVE
            # intercept's std here (regressions.py:637)
            "intercept.std": additive.intercept.std,
        },
    }
    return {"summary": summary, "additive": additive, "dominant": dominant}
