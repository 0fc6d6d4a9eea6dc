"""Block jackknives in JAX (reference semantics: ``nldsc/h2/jackknife.py``).

The fast jackknife forms per-block ``XᵀX`` / ``Xᵀy`` partial sums (here via
``segment_sum``), solves the whole-data system once, and gets every
leave-one-block-out estimate from totals-minus-block — O(M·p²) + n_blocks
p×p solves (``jackknife.py:303-443``).  The slow variant re-solves the
regression per deleted block (kept for testing and NNLS,
``jackknife.py:214-300``).

All math runs in jnp; under ``jax.enable_x64`` (the h2 pipeline default on
CPU) results are float64-exact.  In float32 (the ON-DEVICE h2 path) the
accumulation-sensitive steps are COMPENSATED:
per-block partial sums stay f32 tree reductions (well-conditioned — the
reweighted regressors and χ² responses are nonnegative, so relative error
is ≤ eps·tree-depth), while the block→total fold and the totals−block
delete systems run in double-single (hi+lo) arithmetic via TwoSum, which
removes the only badly-ordered accumulation.  Validated at ≤2e-5 relative
(measured worst ≤9e-6) against the f64 path in tests/test_h2_ondevice.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import ops as jops


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (any rounding mode)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _comp_fold0(xb):
    """Compensated (Neumaier) fold over axis 0 → (hi, lo) with
    hi + lo ≈ Σ xb to ~eps² relative."""
    zeros = jnp.zeros(xb.shape[1:], xb.dtype)

    def step(carry, v):
        s_hi, s_lo = carry
        hi, e = _two_sum(s_hi, v)
        return (hi, s_lo + e), None

    (hi, lo), _ = lax.scan(step, (zeros, zeros), xb)
    return hi, lo


def solve_posdef(a, b):
    """Solve a @ x = b for batched small SPD systems.

    For p ≤ 3 uses the closed-form adjugate — pure elementwise arithmetic,
    no LU/QR decomposition op.  That is what makes the f32 ON-DEVICE h2
    path portable: accelerator backends may lack (or mis-handle) small
    f32 decompositions.  For 4 ≤ p ≤ 32 — the partitioned-h2 regime,
    p = n_annotations + intercept — an UNROLLED Cholesky (static Python
    loops over p, elementwise ops only, batched over the leading dims)
    keeps the on-device property; above that it falls back to
    ``jnp.linalg.solve`` (such runs stay on CPU/f64).

    a: (..., p, p), b: (..., p, 1) → (..., p, 1).
    """
    def _clamp_det(det):
        # sign-preserving magnitude floor: a numerically singular f32
        # system yields det == ±0/subnormal → inf coefficients → the
        # jackknife's (delete − est) differences become inf − inf = NaN
        # and poison every reported std (first hit: UKB-N
        # near-constant-LD partitioned run, r5).  The floor turns that
        # into huge-but-finite garbage — matching what the f64 CPU path
        # honestly reports on identical input; on well-conditioned
        # input it cannot bind (parity suites unchanged).
        tiny = jnp.finfo(det.dtype).tiny
        return jnp.where(det < 0, jnp.minimum(det, -tiny),
                         jnp.maximum(det, tiny))

    p = a.shape[-1]
    if p == 1:
        return b / a[..., :1, :]
    if p == 2:
        det = _clamp_det(a[..., 0, 0] * a[..., 1, 1]
                         - a[..., 0, 1] * a[..., 1, 0])
        x0 = (a[..., 1, 1] * b[..., 0, 0] - a[..., 0, 1] * b[..., 1, 0])
        x1 = (a[..., 0, 0] * b[..., 1, 0] - a[..., 1, 0] * b[..., 0, 0])
        return jnp.stack([x0, x1], axis=-1)[..., None] / det[..., None, None]
    if p == 3:
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        det = _clamp_det(a[..., 0, 0] * c00 + a[..., 0, 1] * c01
                         + a[..., 0, 2] * c02)
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        adj = jnp.stack([
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ], axis=-2)
        return (adj @ b) / det[..., None, None]
    if p <= 32:
        # unrolled Cholesky a = L Lᵀ + triangular solves, all elementwise
        low = [[None] * p for _ in range(p)]
        for i in range(p):
            for j in range(i + 1):
                s = a[..., i, j]
                for k in range(j):
                    s = s - low[i][k] * low[j][k]
                # diagonal floor: on a DEGENERATE (numerically singular)
                # system the f32 Schur complement can go ≤0 and sqrt
                # returns NaN, which then poisons the whole partitioned
                # jackknife std (first hit: UKB-N near-constant-LD run,
                # r5).  Flooring at the dtype tiny yields huge-but-
                # finite garbage — the same honest behavior the f64 CPU
                # path exhibits on identical input.  On genuinely SPD
                # input the floor cannot bind (parity suites unchanged).
                low[i][j] = (jnp.sqrt(jnp.maximum(s, jnp.finfo(s.dtype).tiny))
                             if i == j else s / low[j][j])
        y = []
        for i in range(p):
            s = b[..., i, 0]
            for k in range(i):
                s = s - low[i][k] * y[k]
            y.append(s / low[i][i])
        x = [None] * p
        for i in reversed(range(p)):
            s = y[i]
            for k in range(i + 1, p):
                s = s - low[k][i] * x[k]
            x[i] = s / low[i][i]
        return jnp.stack(x, axis=-1)[..., None]
    return jnp.linalg.solve(a, b)


@dataclass
class JackknifeResult:
    est: jnp.ndarray            # (1, p) whole-data estimate
    jk_est: jnp.ndarray         # (1, p) jackknifed estimate
    jk_var: jnp.ndarray         # (1, p)
    jk_std: jnp.ndarray         # (1, p)
    jk_cov: jnp.ndarray         # (p, p)
    delete_values: jnp.ndarray  # (n_blocks, p)
    separators: np.ndarray      # (n_blocks + 1,) host ints


def get_separators(n: int, n_blocks: int) -> np.ndarray:
    """Evenly-spaced block boundaries (jackknife.py:85-91)."""
    return np.floor(np.linspace(0, n, n_blocks + 1)).astype(int)


def block_ids(separators: np.ndarray, n: int) -> np.ndarray:
    """Map each row to its jackknife block (host helper)."""
    return (np.searchsorted(separators[1:-1], np.arange(n), side="right")
            .astype(np.int32))


def jackknife_moments(pseudovalues: jnp.ndarray):
    """Pseudovalues -> (jk_est, jk_var, jk_std, jk_cov) (jackknife.py:57-83).

    ``jk_cov = cov(pseudovalues, ddof=1) / n_blocks``.
    """
    n_blocks = pseudovalues.shape[0]
    mean = jnp.mean(pseudovalues, axis=0, keepdims=True)       # (1, p)
    centered = pseudovalues - mean
    cov = centered.T @ centered / (n_blocks - 1) / n_blocks    # (p, p)
    var = jnp.diag(cov)[None, :]
    return mean, var, jnp.sqrt(var), cov


def delete_values_to_pseudovalues(delete_values: jnp.ndarray,
                                  est: jnp.ndarray) -> jnp.ndarray:
    """``n·est − (n−1)·delete`` (jackknife.py:176-211)."""
    n_blocks = delete_values.shape[0]
    return n_blocks * est - (n_blocks - 1) * delete_values


def _result(est, delete_values, separators) -> JackknifeResult:
    pseudo = delete_values_to_pseudovalues(delete_values, est)
    jk_est, jk_var, jk_std, jk_cov = jackknife_moments(pseudo)
    return JackknifeResult(est=est, jk_est=jk_est, jk_var=jk_var,
                           jk_std=jk_std, jk_cov=jk_cov,
                           delete_values=delete_values, separators=separators)


@partial(jax.jit, static_argnames=("nb",))
def _jk_fast_core(x, y, ids, *, nb: int):
    """The whole fast-jackknife compute as ONE compiled program.

    The on-device h2 path previously issued every jnp op eagerly — one
    compile each, 189 per estimate (counted); this seam plus the
    ``_wls_core`` one collapse the bulk of them.  Numerics unchanged
    (same ops, same order — jit only fuses the schedule).
    """
    n, p = x.shape
    # per-block partial sums of XᵀX (nb, p, p) and Xᵀy (nb, p)
    xtx_b = jops.segment_sum(x[:, :, None] * x[:, None, :], ids,
                             num_segments=nb)
    xty_b = jops.segment_sum(x * y, ids, num_segments=nb)

    if x.dtype == jnp.float32:
        # on-device (f32) path: compensated block→total fold; the
        # totals−block systems are formed in double-single so the
        # subtraction does not re-round an already-rounded total; solves
        # via the decomposition-free closed form (solve_posdef)
        xtx_hi, xtx_lo = _comp_fold0(xtx_b)
        xty_hi, xty_lo = _comp_fold0(xty_b)
        xtx = xtx_hi + xtx_lo
        xty = xty_hi + xty_lo
        xtx_del = (xtx_hi - xtx_b) + xtx_lo
        xty_del = (xty_hi - xty_b) + xty_lo
        est = solve_posdef(xtx, xty[:, None]).reshape(1, p)
        delete = solve_posdef(xtx_del, xty_del[..., None]).reshape(nb, p)
    else:
        xtx = jnp.sum(xtx_b, axis=0)
        xty = jnp.sum(xty_b, axis=0)
        xtx_del = xtx[None] - xtx_b
        xty_del = xty[None] - xty_b
        est = jnp.linalg.solve(xtx, xty[:, None]).reshape(1, p)
        delete = jnp.linalg.solve(xtx_del, xty_del[..., None]).reshape(nb, p)
    pseudo = delete_values_to_pseudovalues(delete, est)
    jk_est, jk_var, jk_std, jk_cov = jackknife_moments(pseudo)
    return est, delete, jk_est, jk_var, jk_std, jk_cov


def lstsq_jackknife_fast(x: jnp.ndarray, y: jnp.ndarray,
                         n_blocks: int | None = None,
                         separators: np.ndarray | None = None) -> JackknifeResult:
    """Fast block jackknife for the regression y ~ x."""
    n, p = x.shape
    separators = _check_separators(n, n_blocks, separators)
    ids = jnp.asarray(block_ids(separators, n))
    nb = len(separators) - 1
    est, delete, jk_est, jk_var, jk_std, jk_cov = _jk_fast_core(
        x, y, ids, nb=nb)
    return JackknifeResult(est=est, jk_est=jk_est, jk_var=jk_var,
                           jk_std=jk_std, jk_cov=jk_cov,
                           delete_values=delete, separators=separators)


def lstsq_jackknife_slow(x: jnp.ndarray, y: jnp.ndarray,
                         n_blocks: int | None = None,
                         separators: np.ndarray | None = None,
                         nn: bool = False) -> JackknifeResult:
    """Slow jackknife: re-fit per deleted block (optionally NNLS on host)."""
    n, p = x.shape
    separators = _check_separators(n, n_blocks, separators)
    nb = len(separators) - 1

    if nn:
        from scipy.optimize import nnls  # noqa: PLC0415

        xh = np.asarray(x, dtype=np.float64)
        yh = np.asarray(y, dtype=np.float64).ravel()
        est = jnp.asarray(nnls(xh, yh)[0]).reshape(1, p)
        rows = []
        for j in range(nb):
            keep = np.r_[0:separators[j], separators[j + 1]:n]
            rows.append(nnls(xh[keep], yh[keep])[0])
        delete = jnp.asarray(np.stack(rows))
        return _result(est, delete, separators)

    est = jnp.linalg.lstsq(x, y)[0].reshape(1, p)
    rows = []
    for j in range(nb):
        # zeroed rows leave the (full-rank) least-squares minimizer unchanged
        mask = jnp.ones((n, 1), x.dtype)
        mask = mask.at[separators[j]:separators[j + 1]].set(0.0)
        rows.append(jnp.linalg.lstsq(x * mask, y * mask)[0].reshape(p))
    delete = jnp.stack(rows)
    return _result(est, delete, separators)


@jax.jit
def _ratio_core(est, numer_delete, denom_delete):
    nb = numer_delete.shape[0]
    pseudo = nb * est - (nb - 1) * numer_delete / denom_delete
    jk_est, jk_var, jk_std, jk_cov = jackknife_moments(pseudo)
    return jk_est, jk_var, jk_std, jk_cov, numer_delete / denom_delete


def ratio_jackknife(est: jnp.ndarray, numer_delete: jnp.ndarray,
                    denom_delete: jnp.ndarray) -> JackknifeResult:
    """Jackknife for a ratio estimate (jackknife.py:446-527)."""
    jk_est, jk_var, jk_std, jk_cov, delete = _ratio_core(
        est, numer_delete, denom_delete)
    return JackknifeResult(est=est, jk_est=jk_est, jk_var=jk_var,
                           jk_std=jk_std, jk_cov=jk_cov,
                           delete_values=delete,
                           separators=np.array([]))


def _check_separators(n: int, n_blocks: int | None,
                      separators: np.ndarray | None) -> np.ndarray:
    if separators is not None:
        separators = np.sort(np.asarray(separators))
        if separators[0] != 0 or separators[-1] != n:
            raise ValueError("separators must span [0, n]")
        return separators
    if n_blocks is None:
        raise ValueError("Must specify either n_blocks or separators.")
    if n_blocks > n:
        raise ValueError("More blocks than data points.")
    return get_separators(n, n_blocks)
