"""Iteratively re-weighted least squares (reference: ``nldsc/h2/irwls.py``).

Exactly two weight-update iterations (``irwls.py:113``), then a block
jackknife on the re-weighted system.  Weight normalization divides by the
weight sum (``reweigh``, ``irwls.py:12-41``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import jackknife as jk


def reweigh(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Multiply rows of x by w normalized to sum 1 (rejects w <= 0)."""
    if bool(jnp.any(w <= 0)):
        raise ValueError("Weights must be > 0")
    n, _ = x.shape
    if w.shape != (n, 1):
        raise ValueError(f"w has shape {w.shape}. w must have shape (n, 1).")
    return x * (w / jnp.sum(w))


def qr_solve_mgs(x, y):
    """Least squares via modified Gram-Schmidt QR, unrolled over the
    (trace-static, small: p ≤ 33) column count.

    Why not ``lstsq``/Householder: accelerator backends may lack a fast
    small-matrix QR (the remote QR compile here took ~20 min — see
    ``wls``).  Why not normal equations: forming XᵀX SQUARES the
    condition number, and in f32 a near-collinear LD design (constant
    scores ⇒ the ld column ≈ the intercept column; first hit: the r5
    UKB-N run) loses every digit — the adjugate solve returned
    inf/NaN coefficients.  MGS keeps κ(X) un-squared: pure
    elementwise + reduction ops, compiles in seconds, and its f32 error
    ~κ·eps matches the on-device parity tolerance on well-conditioned
    systems (tests/test_h2_ondevice.py).  ``rkk`` is floored at the
    dtype tiny so exactly-collinear columns degrade to huge-but-finite
    coefficients instead of 0/0 NaNs.
    """
    p = x.shape[1]
    qs: list = []
    r_entries = {}
    for k in range(p):
        v = x[:, k:k + 1]
        for j in range(k):
            rjk = jnp.sum(qs[j] * v)
            v = v - rjk * qs[j]
            r_entries[(j, k)] = rjk
        rkk = jnp.maximum(jnp.sqrt(jnp.sum(v * v)),
                          jnp.finfo(x.dtype).tiny)
        r_entries[(k, k)] = rkk
        qs.append(v / rkk)
    # back-substitute R coef = Qᵀ y (unrolled)
    qty = [jnp.sum(q * y) for q in qs]
    coef = [None] * p
    for k in range(p - 1, -1, -1):
        acc = qty[k]
        for j in range(k + 1, p):
            acc = acc - r_entries[(k, j)] * coef[j]
        coef[k] = acc / r_entries[(k, k)]
    return jnp.stack(coef).reshape(p, 1)


@jax.jit
def _wls_core(x, y, w):
    """Reweigh + solve as one compiled program (no w>0 validation — the
    caller's weight functions clip/guard; ``wls`` keeps the check for
    direct use).  Dtype dispatch is trace-static."""
    xw = x * (w / jnp.sum(w))
    yw = y * (w / jnp.sum(w))
    if xw.dtype == jnp.float32:
        return qr_solve_mgs(xw, yw)
    return jnp.linalg.lstsq(xw, yw)[0]


def wls(x: jnp.ndarray, y: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted least squares; returns the coefficient column (p, 1).

    f64 (the default CPU path) uses QR ``lstsq`` like the reference; f32
    (the on-device path) solves the normal equations with the
    decomposition-free closed form instead — accelerator backends may
    lack fast small-matrix QR, and the 2–3-column LD-score systems are
    well-conditioned enough that the difference vs QR is below the
    on-device parity tolerance (tests/test_h2_ondevice.py).
    """
    if bool(jnp.any(w <= 0)):
        raise ValueError("Weights must be > 0")
    return _wls_core(x, y, w)


def irwls(x: jnp.ndarray, y: jnp.ndarray, update_func, n_blocks: int,
          w: jnp.ndarray, slow: bool = False, separators=None,
          n_iter: int = 2) -> jk.JackknifeResult:
    """IRWLS driver (irwls.py:75-130).

    ``update_func`` maps the current WLS coefficient column (p, 1) to new
    (unsquare-rooted) weights; it runs exactly ``n_iter`` times (reference
    hardcodes 2).  The returned jackknife uses the final sqrt-weights.
    """
    n, _ = x.shape
    if y.shape != (n, 1):
        raise ValueError(f"y has shape {y.shape}. y must have shape ({n}, 1).")
    w = jnp.ones_like(y) if w is None else w
    if w.shape != (n, 1):
        raise ValueError(f"w has shape {w.shape}. w must have shape ({n}, 1).")

    w = jnp.sqrt(w)
    for _ in range(n_iter):
        coef = wls(x, y, w)
        new_w = jnp.sqrt(update_func(coef))
        if new_w.shape != w.shape:
            raise ValueError("New weights must have same shape.")
        w = new_w

    xw = reweigh(x, w)
    yw = reweigh(y, w)
    if slow:
        return jk.lstsq_jackknife_slow(xw, yw, n_blocks, separators=separators)
    return jk.lstsq_jackknife_fast(xw, yw, n_blocks, separators=separators)
