"""On-device (f32) h2 path vs the default f64-on-CPU path.

The on-device h2 runs in f32 with compensated jackknife accumulation (jackknife.py `_comp_fold0` +
double-single delete systems).  These tests validate the numerics
strategy: the f32 path (same code, x64 disabled) must match the f64 path
to ≤2e-5 relative on every reported statistic (measured worst ≤9e-6
across two-step/free/constrained/one-stg and M=400k — the residual comes
from f32 input rounding and the QR in the IRWLS warm-up, not from
accumulation); diagnostics with near-zero expectation (residuals.mean)
are compared absolutely.  The CPU-vs-GPU backend difference on identical
f32 ops is ulp-level when matmuls run at full f32 precision (the
on-device path sets it), so CPU f32 is a faithful stand-in; chip_smoke.py
runs the real-card comparison.
"""

import numpy as np
import pytest

from nldsc_jax.config import H2Config
from nldsc_jax.h2.pipeline import estimate_h2_frames

from test_h2 import synth_h2_data


def _frames(rng, m=60000, **kw):
    import pandas as pd

    data = synth_h2_data(rng, m=m, **kw)
    snp = np.array([f"rs{i}" for i in range(m)])
    ss = pd.DataFrame({"SNP": snp, "Z": np.sqrt(np.ravel(data["chisq"])),
                       "N": np.ravel(data["N"])})
    ld = pd.DataFrame({"SNP": snp, "L2": np.ravel(data["ld"]),
                       "L2D": np.ravel(data["ldd"])})
    return ss, ld, int(data["M"][0, 0]), int(data["MD"][0, 0])


def _run(ss, ld, M, MD, on_device, **kw):
    cfg = H2Config(n_blocks=200, chisq_max=1e9, on_device=on_device, **kw)
    return estimate_h2_frames(ss, ld, M, MD, cfg)["summary"]


def _compare(f64, f32, rtol=2e-5):
    for part in ("additive", "dominant"):
        for key, val in f64[part].items():
            mine = f32[part][key]
            if isinstance(val, bool):
                assert mine == val, (part, key)
            else:
                # atol guards near-zero diagnostics (residuals.mean has
                # expectation 0, so its relative error is meaningless)
                np.testing.assert_allclose(
                    np.float64(mine), np.float64(val), rtol=rtol,
                    atol=1e-6, err_msg=f"{part}.{key}")


@pytest.mark.parametrize("mode", ["two_step", "free", "constrained"])
def test_ondevice_matches_f64(mode):
    rng = np.random.default_rng(501)
    ss, ld, M, MD = _frames(rng, h2_add=0.35, h2_dom=0.03, n_gwas=20000.0)
    kw = {"two_step": 30} if mode == "two_step" else (
        {"intercept_h2": 1.0} if mode == "constrained" else {"two_step": None})
    f64 = _run(ss, ld, M, MD, on_device=False, **kw)
    f32 = _run(ss, ld, M, MD, on_device=True, **kw)
    _compare(f64, f32)


def test_ondevice_one_stage():
    rng = np.random.default_rng(502)
    ss, ld, M, MD = _frames(rng, m=40000, h2_add=0.3, h2_dom=0.02,
                            n_gwas=15000.0)
    f64 = _run(ss, ld, M, MD, on_device=False, strategy="one-stg")
    f32 = _run(ss, ld, M, MD, on_device=True, strategy="one-stg")
    for key, val in f64["joint"].items() if "joint" in f64 else ():
        np.testing.assert_allclose(np.float64(f32["joint"][key]),
                                   np.float64(val), rtol=1e-6, atol=1e-10)
    _compare(f64, f32)


def test_ondevice_large_m_accumulation():
    """Large M stresses the accumulation error the compensation targets."""
    rng = np.random.default_rng(503)
    ss, ld, M, MD = _frames(rng, m=400000, h2_add=0.4, h2_dom=0.02,
                            n_gwas=50000.0)
    f64 = _run(ss, ld, M, MD, on_device=False, two_step=30)
    f32 = _run(ss, ld, M, MD, on_device=True, two_step=30)
    _compare(f64, f32)


def test_solve_posdef_unrolled_cholesky():
    """p >= 4 solves via the unrolled elementwise Cholesky (no linalg op)
    match LAPACK at f64 precision — the partitioned on-device solver."""
    import jax

    from nldsc_jax.h2.jackknife import solve_posdef

    rng = np.random.default_rng(504)
    with jax.enable_x64(True):
        for p in (4, 6, 12):
            r = rng.normal(size=(8, p, p))
            a = r @ np.swapaxes(r, -1, -2) + 3.0 * np.eye(p)
            b = rng.normal(size=(8, p, 1))
            got = np.asarray(solve_posdef(a, b))
            want = np.linalg.solve(a, b)
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_ondevice_partitioned(tmp_path):
    """--on-device x --partitioned (r4: the exclusion is lifted): the f32
    unrolled-Cholesky path matches the f64 CPU path at <=2e-5 on every
    per-annotation statistic (p = 5 annotations + intercept = 6)."""
    import pandas as pd

    from nldsc_jax.h2.pipeline import estimate_h2_partitioned

    rng = np.random.default_rng(505)
    m, p = 60000, 5
    base = rng.uniform(2.0, 60.0, size=m)
    parts = rng.dirichlet(np.ones(p), size=m) * base[:, None]
    coefs = np.array([2e-5, 5e-5, 0.0, 1e-5, 3e-5])
    n_gwas = 20000.0
    mean_chi2 = 1.0 + n_gwas * parts @ coefs
    chisq = mean_chi2 * rng.chisquare(1, size=m) / 1.0
    snp = np.array([f"rs{i}" for i in range(m)])
    names = [f"a{k}.L2" for k in range(p)]

    ld = pd.DataFrame({"CHR": 1, "SNP": snp, "BP": np.arange(m) * 100})
    for k, nm in enumerate(names):
        ld[nm] = parts[:, k]
    l2_path = str(tmp_path / "part.L2")
    ld.to_csv(l2_path, sep="\t", index=False)
    pd.DataFrame({nm: [float(m) / p] for nm in names}).to_csv(
        str(tmp_path / "part.M_5_50"), sep="\t", index=False)
    ss_path = str(tmp_path / "part.sumstats")
    pd.DataFrame({"SNP": snp, "Z": np.sqrt(chisq),
                  "N": n_gwas}).to_csv(ss_path, sep="\t", index=False)

    kw = dict(n_blocks=100, chisq_max=1e9)
    f64 = estimate_h2_partitioned(ss_path, l2_path, l2_path,
                                  on_device=False, **kw)
    f32 = estimate_h2_partitioned(ss_path, l2_path, l2_path,
                                  on_device=True, **kw)
    for key in ("lambda_gc", "chisq.mean", "intercept", "intercept.std"):
        np.testing.assert_allclose(f32[key], f64[key], rtol=2e-5,
                                   err_msg=key)
    np.testing.assert_allclose(f32["total"]["hsq"], f64["total"]["hsq"],
                               rtol=2e-5, atol=1e-7)
    for nm in names:
        for key in ("hsq", "hsq.std", "prop", "enrichment"):
            np.testing.assert_allclose(
                f32["annotations"][nm][key], f64["annotations"][nm][key],
                rtol=5e-5, atol=1e-6, err_msg=f"{nm}.{key}")


def test_ondevice_degenerate_constant_ld_no_crash():
    """Near-constant L2 makes the regression design collinear with the
    intercept; pre-fix, the f32 on-device path crashed on this data with
    'Weights must be > 0' (normal-equation solve -> inf coefficient ->
    weight underflow -> XLA f32 subnormal flush -> exact 0), while f64
    returned an honestly-garbage finite estimate.  The fixture is a
    REAL subset of the r5 UKB-N run's outputs (M=65,536 x N=300,032
    synthetic unlinked genotypes -> L2 = 1 ± 3e-4 everywhere; every 4th
    row — verified to still crash the pre-fix code); fixed by the MGS-QR
    f32 solve (irwls.qr_solve_mgs) + the weight tiny-floor."""
    import os

    import pandas as pd

    data = np.load(os.path.join(os.path.dirname(__file__), "data",
                                "degenerate_ukb_subset.npz"))
    m = data["l2"].shape[0]
    snp = np.array([f"rs{i}" for i in range(m)])
    ss = pd.DataFrame({"SNP": snp, "Z": data["z"].astype(np.float64),
                       "N": float(data["n"])})
    ld = pd.DataFrame({"SNP": snp, "L2": data["l2"].astype(np.float64),
                       "L2D": data["l2d"].astype(np.float64)})
    # two_step=30 is the crash path (the CLI default strategy): step 1's
    # free-intercept system is the collinear one.  NOTE: exact CLI
    # defaults (no chisq_max override) — the failure is a numerical
    # knife-edge and the _run helper's chisq_max=1e9 perturbs it enough
    # to miss the pre-fix crash.
    for on_device in (True, False):
        cfg = H2Config(n_blocks=200, on_device=on_device, two_step=30.0)
        summary = estimate_h2_frames(ss, ld, m, m, cfg)["summary"]
        assert np.isfinite(summary["additive"]["hsq"]), on_device
        assert np.isfinite(summary["additive"]["hsq.std"]), on_device


def test_qr_solve_mgs_ill_conditioned_f32():
    """The f32 WLS solve must handle a near-collinear design.  Forming
    XᵀX squares the condition number: the old adjugate normal-equation
    solve loses all 24 f32 bits at κ(X) ≈ 3e3 (κ² ≈ 1e7) and returned
    inf/NaN on the UKB-N degenerate system; MGS QR keeps κ un-squared
    and stays within ~κ·eps of the f64 reference answer."""
    import jax.numpy as jnp

    from nldsc_jax.h2.irwls import qr_solve_mgs

    rng = np.random.default_rng(3)
    n = 20000
    ld = 1.0 + 3e-4 * rng.standard_normal(n)      # near-constant column
    x64 = np.stack([ld, np.ones(n)], axis=1)

    # On a near-collinear f32 design the INDIVIDUAL coefficients are not
    # recoverable by any solver (already the f32 CAST of x/y perturbs
    # them by O(eps·κ²) — the measured spread across environments is
    # ±1); the invariants the h2 pipeline needs from the solve are:
    # finite, bounded (the weight formula squares intercept + c·ld — a
    # coefficient blow-up underflows the weights to 0 and kills the
    # run), and prediction-accurate (x@coef is the well-conditioned
    # functional the IRWLS weights actually consume).
    y_exact = (0.7 * ld - 0.2).reshape(n, 1)
    y64 = y_exact + 1e-3 * rng.standard_normal((n, 1))
    for y in (y_exact, y64):
        mgs = np.asarray(qr_solve_mgs(jnp.asarray(x64, jnp.float32),
                                      jnp.asarray(y, jnp.float32)))
        assert np.all(np.isfinite(mgs)) and np.all(np.abs(mgs) < 1e2)
        np.testing.assert_allclose(x64 @ mgs,
                                   x64 @ np.linalg.lstsq(x64, y,
                                                         rcond=None)[0],
                                   rtol=0, atol=5e-3)

