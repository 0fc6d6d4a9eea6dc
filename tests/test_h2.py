"""h2 regression tests: jackknife internals + true parity vs the reference
implementation (imported from /root/reference when present, skipped otherwise).
"""

import os
import sys

import numpy as np
import pytest

import jax

REF_NLDSC = "/root/reference/nldsc"


@pytest.fixture(scope="module")
def ref_reg(tmp_path_factory):
    """Import the reference h2 regression modules as a parity oracle."""
    if not os.path.isdir(REF_NLDSC):
        pytest.skip("reference tree not available")
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("refimport"))  # absorb nldsc.log side effect
    sys.path.insert(0, REF_NLDSC)
    try:
        import h2.regressions as ref_regressions  # noqa: PLC0415
        yield ref_regressions
    finally:
        sys.path.remove(REF_NLDSC)
        os.chdir(cwd)


def synth_h2_data(rng, m=20000, h2_add=0.4, h2_dom=0.05, n_gwas=50000.0):
    ld = rng.uniform(1.0, 60.0, size=m)
    ldd = np.abs(ld * 0.25 + rng.normal(0, 2, size=m))
    M = float(m)
    MD = float(int(0.6 * m))
    expect = 1.0 + n_gwas * (h2_add * ld / M + h2_dom * ldd / MD)
    chisq = expect * rng.chisquare(1, size=m)
    chisq = np.clip(chisq, 1e-8, None)
    N = np.full(m, n_gwas) + rng.integers(-500, 500, size=m)
    c = chisq.reshape(m, 1)
    return {
        "chisq": c, "ld": ld.reshape(m, 1), "ldd": ldd.reshape(m, 1),
        "N": N.astype(np.float64).reshape(m, 1),
        "M": np.array([[M]]), "MD": np.array([[MD]]),
    }


def test_fast_vs_slow_jackknife():
    rng = np.random.default_rng(7)
    from nldsc_jax.h2 import jackknife as jk

    with jax.enable_x64(True):
        n, p = 5000, 2
        x = np.column_stack([rng.uniform(1, 50, n), np.ones(n)])
        y = (x @ np.array([0.003, 1.1]) + rng.normal(0, 0.6, n)).reshape(n, 1)
        fast = jk.lstsq_jackknife_fast(x, y, n_blocks=47)
        slow = jk.lstsq_jackknife_slow(x, y, n_blocks=47)
        np.testing.assert_allclose(fast.est, slow.est, rtol=1e-9)
        np.testing.assert_allclose(fast.delete_values, slow.delete_values,
                                   rtol=1e-7, atol=1e-12)
        np.testing.assert_allclose(fast.jk_std, slow.jk_std, rtol=1e-6)


def test_jackknife_pseudovalue_identity():
    rng = np.random.default_rng(8)
    from nldsc_jax.h2 import jackknife as jk

    with jax.enable_x64(True):
        d = np.asarray(rng.normal(size=(30, 2)))
        est = np.asarray(rng.normal(size=(1, 2)))
        pseudo = jk.delete_values_to_pseudovalues(np.asarray(d), np.asarray(est))
        np.testing.assert_allclose(np.asarray(pseudo), 30 * est - 29 * d)
        seps = jk.get_separators(100, 7)
        assert seps[0] == 0 and seps[-1] == 100 and len(seps) == 8


def test_nnls_slow_jackknife():
    rng = np.random.default_rng(9)
    from nldsc_jax.h2 import jackknife as jk

    with jax.enable_x64(True):
        n = 400
        x = np.column_stack([rng.uniform(1, 10, n), np.ones(n)])
        y = (x @ np.array([0.5, 2.0]) + rng.normal(0, 0.1, n)).reshape(n, 1)
        res = jk.lstsq_jackknife_slow(x, y, n_blocks=10, nn=True)
        assert np.all(np.asarray(res.est) >= 0)


def test_h2_recovers_truth():
    rng = np.random.default_rng(1234)
    from nldsc_jax.h2.regression import hsq_estimate

    # keep E[chi2] well under the two-step cutoff (30) so step-1 masking
    # doesn't truncate the signal: max expectation ~ 1 + N*h2*Lmax/M ~ 10
    data = synth_h2_data(rng, m=30000, h2_add=0.45, h2_dom=0.0, n_gwas=10000.0)
    with jax.enable_x64(True):
        out = hsq_estimate(
            data["chisq"], data["ld"], data["ld"], data["ldd"], data["ldd"],
            data["N"], data["M"], data["MD"], n_blocks=100, two_step=30)
    s = out["summary"]
    # single-draw sampling noise: bound by the estimator's own jackknife SE
    assert abs(s["additive"]["hsq"] - 0.45) < 4 * s["additive"]["hsq.std"] + 0.02
    assert abs(s["additive"]["intercept"] - 1.0) < 0.15
    assert s["additive"]["hsq.std"] < 0.1
    assert not s["additive"]["intercept.constrained"]


def _run_both(ref_reg, data, intercept=None, two_step=None, n_blocks=50):
    from nldsc_jax.h2.regression import hsq_estimate

    ref = ref_reg.HSQEstimator(
        chisq=data["chisq"], x_add=data["ld"], w_add=data["ld"],
        x_dom=data["ldd"], w_dom=data["ldd"], N=data["N"],
        M_add=data["M"], M_dom=data["MD"], n_blocks=n_blocks,
        intercept_add=intercept, slow=False, two_step=two_step,
    ).summary()
    with jax.enable_x64(True):
        ours = hsq_estimate(
            data["chisq"], data["ld"], data["ld"], data["ldd"], data["ldd"],
            data["N"], data["M"], data["MD"], n_blocks=n_blocks,
            intercept_add=intercept, two_step=two_step)["summary"]
    return ref, ours


def _compare_summaries(ref, ours, rtol=1e-6):
    for part in ("additive", "dominant"):
        for key, val in ref[part].items():
            mine = ours[part][key]
            if isinstance(val, bool):
                assert mine == val, (part, key)
            else:
                np.testing.assert_allclose(
                    np.float64(mine), np.float64(val), rtol=rtol, atol=1e-12,
                    err_msg=f"{part}.{key}")


@pytest.mark.parametrize("mode", ["two_step", "free"])
def test_parity_vs_reference(ref_reg, mode):
    rng = np.random.default_rng(99)
    data = synth_h2_data(rng, m=12000)
    kwargs = {
        "two_step": {"two_step": 30},
        "free": {"two_step": None},
    }[mode]
    ref, ours = _run_both(ref_reg, data, **kwargs)
    _compare_summaries(ref, ours)


def test_parity_vs_reference_constrained_additive(ref_reg):
    rng = np.random.default_rng(98)
    # The reference's own dominance stage crashes on a constrained additive
    # intercept (regressions.py:540 calls .flatten() on a float — a latent
    # bug its CLI never reaches; ours handles it).  Compare additive only.
    from nldsc_jax.h2.regression import hsq_additive

    data = synth_h2_data(rng, m=12000)
    ref = ref_reg.HSQAdditive(
        data["chisq"], data["ld"], data["ld"], data["N"], data["M"],
        n_blocks=50, intercept=1.0, slow=False, two_step=None)
    with jax.enable_x64(True):
        ours = hsq_additive(data["chisq"], data["ld"], data["ld"], data["N"],
                            data["M"], n_blocks=50, intercept=1.0)
    np.testing.assert_allclose(ours.total.value, ref.total.value, rtol=1e-6)
    np.testing.assert_allclose(ours.total.std, ref.total.std, rtol=1e-6)
    assert ours.constrain_intercept and ours.intercept.value == 1.0


def test_partitioned_h2_matches_reference(ref_reg):
    # multi-annotation (partitioned) regression: works in both (the
    # reference only blocks it for two-step), and matches exactly
    rng = np.random.default_rng(55)
    m = 8000
    ld1 = rng.uniform(1, 40, m)
    ld2 = rng.uniform(1, 20, m)
    w = (ld1 + ld2).reshape(m, 1)
    N = np.full((m, 1), 20000.0)
    M = np.array([[6000.0, 4000.0]])
    expect = 1 + 20000 * (0.3 * ld1 / 6000 + 0.1 * ld2 / 4000)
    chisq = (expect * rng.chisquare(1, m)).clip(1e-8).reshape(m, 1)
    x = np.column_stack([ld1, ld2])

    from nldsc_jax.h2.regression import hsq_additive

    ref = ref_reg.HSQAdditive(chisq, x, w, N, M, n_blocks=40, two_step=None)
    with jax.enable_x64(True):
        ours = hsq_additive(chisq, x, w, N, M, n_blocks=40, two_step=None)
    np.testing.assert_allclose(ours.total.value, ref.total.value, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ours.category.value),
                               np.ravel(ref.category.value), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ours.category.std),
                               np.ravel(ref.category.std), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(ours.enrichment),
                               np.ravel(ref.enrichment), rtol=1e-9)
    np.testing.assert_allclose(ours.intercept.value, ref.intercept.value,
                               rtol=1e-9)


def test_parity_vs_reference_separate_weights(ref_reg):
    """--w-ld != --ref-ld (VERDICT r2 item 7): the reference CODE accepts
    separate w_add/w_dom (only its CLI forbids them) — parity-test the
    lifted restriction directly against the reference estimator."""
    from nldsc_jax.h2.regression import hsq_estimate

    rng = np.random.default_rng(77)
    data = synth_h2_data(rng, m=12000, h2_add=0.3, h2_dom=0.02,
                         n_gwas=20000.0)
    m = len(data["chisq"])
    w_add = data["ld"] * rng.uniform(0.5, 1.5, size=(m, 1))
    w_dom = data["ldd"] * rng.uniform(0.5, 1.5, size=(m, 1)) + 0.1
    ref = ref_reg.HSQEstimator(
        chisq=data["chisq"], x_add=data["ld"], w_add=w_add,
        x_dom=data["ldd"], w_dom=w_dom, N=data["N"],
        M_add=data["M"], M_dom=data["MD"], n_blocks=50,
        intercept_add=None, slow=False, two_step=30,
    ).summary()
    with jax.enable_x64(True):
        ours = hsq_estimate(
            data["chisq"], data["ld"], w_add, data["ldd"], w_dom,
            data["N"], data["M"], data["MD"], n_blocks=50,
            two_step=30)["summary"]
    _compare_summaries(ref, ours)


def test_separate_weights_slow_jackknife_crosscheck():
    """Separate-weight fit: fast and slow jackknives must agree."""
    from nldsc_jax.h2.regression import hsq_estimate

    rng = np.random.default_rng(78)
    data = synth_h2_data(rng, m=6000, h2_add=0.3, h2_dom=0.02,
                         n_gwas=15000.0)
    m = len(data["chisq"])
    w_add = data["ld"] * rng.uniform(0.5, 1.5, size=(m, 1))
    w_dom = data["ldd"] * rng.uniform(0.5, 1.5, size=(m, 1)) + 0.1
    with jax.enable_x64(True):
        fast = hsq_estimate(data["chisq"], data["ld"], w_add, data["ldd"],
                            w_dom, data["N"], data["M"], data["MD"],
                            n_blocks=40, two_step=30)["summary"]
        slow = hsq_estimate(data["chisq"], data["ld"], w_add, data["ldd"],
                            w_dom, data["N"], data["M"], data["MD"],
                            n_blocks=40, two_step=30, slow=True)["summary"]
    for part in ("additive", "dominant"):
        for key in ("hsq", "hsq.std", "intercept"):
            np.testing.assert_allclose(
                np.float64(slow[part][key]), np.float64(fast[part][key]),
                rtol=1e-8, err_msg=f"{part}.{key}")


def test_estimate_h2_frames_separate_w_ld():
    """The pipeline's w_ld frame merge/align equals a direct estimator
    call on the hand-aligned arrays (incl. SNPs dropped by the merge)."""
    import pandas as pd

    from nldsc_jax.config import H2Config
    from nldsc_jax.h2.pipeline import estimate_h2_frames
    from nldsc_jax.h2.regression import hsq_estimate

    rng = np.random.default_rng(79)
    data = synth_h2_data(rng, m=5000, h2_add=0.3, h2_dom=0.0,
                         n_gwas=10000.0)
    m = len(data["chisq"])
    snp = np.array([f"rs{i}" for i in range(m)])
    z = np.sqrt(np.ravel(data["chisq"]))
    ss = pd.DataFrame({"SNP": snp, "Z": z, "N": np.ravel(data["N"])})
    ld = pd.DataFrame({"SNP": snp, "L2": np.ravel(data["ld"]),
                       "L2D": np.ravel(data["ldd"])})
    w_add = np.ravel(data["ld"]) * rng.uniform(0.5, 1.5, size=m)
    w_dom = np.ravel(data["ldd"]) * rng.uniform(0.5, 1.5, size=m) + 0.1
    # weight frame misses some SNPs: the merge must drop them everywhere
    keep = np.ones(m, bool)
    keep[::97] = False
    w_frame = pd.DataFrame({"SNP": snp[keep], "L2": w_add[keep],
                            "L2D": w_dom[keep]})
    cfg = H2Config(n_blocks=40, chisq_max=1e9, two_step=30)
    res = estimate_h2_frames(ss, ld, int(data["M"][0, 0]),
                             int(data["MD"][0, 0]), cfg,
                             w_ld=w_frame)["summary"]
    k = np.flatnonzero(keep)
    with jax.enable_x64(True):
        direct = hsq_estimate(
            data["chisq"][k], data["ld"][k], w_add[k].reshape(-1, 1),
            data["ldd"][k], w_dom[k].reshape(-1, 1), data["N"][k],
            data["M"], data["MD"], n_blocks=40, two_step=30)["summary"]
    for part in ("additive", "dominant"):
        for key in ("hsq", "hsq.std", "intercept"):
            np.testing.assert_allclose(
                np.float64(res[part][key]), np.float64(direct[part][key]),
                rtol=1e-10, err_msg=f"{part}.{key}")


def test_two_step_rejects_partitioned():
    from nldsc_jax.h2.regression import hsq_additive

    rng = np.random.default_rng(3)
    m = 500
    x = rng.uniform(1, 10, (m, 2))
    y = rng.uniform(0.5, 3, (m, 1))
    w = np.ones((m, 1))
    N = np.full((m, 1), 1000.0)
    M = np.array([[300.0, 200.0]])
    with jax.enable_x64(True), pytest.raises(ValueError, match="partitioned"):
        hsq_additive(y, x, w, N, M, n_blocks=10, two_step=30)


def test_liability_conversion():
    from scipy import stats as ss

    from nldsc_jax.h2.regression import h2_obs_to_liability

    K, P = 0.01, 0.5
    thresh = ss.norm.isf(K)
    expected = K**2 * (1 - K)**2 / (P * (1 - P) * ss.norm.pdf(thresh)**2)
    assert h2_obs_to_liability(0.3, P, K) == pytest.approx(0.3 * expected)
    assert h2_obs_to_liability(0.3, float("nan"), float("nan")) == 0.3
    with pytest.raises(ValueError):
        h2_obs_to_liability(0.3, 1.5, K)


def test_liability_in_pipeline_summary(tmp_path):
    import pandas as pd

    from nldsc_jax.h2.pipeline import estimate_h2

    rng = np.random.default_rng(4)
    m = 3000
    ld = pd.DataFrame({
        "CHR": 22, "SNP": [f"rs{i}" for i in range(m)],
        "BP": np.arange(1, m + 1) * 100,
        "L2": rng.uniform(1, 30, m), "L2D": rng.uniform(0, 2, m),
        "MAF": 0.3, "WSA": 20, "WSD": 18, "WSDE": 4, "RSTD": 0.5,
    })
    l2_path = str(tmp_path / "x.L2")
    ld.to_csv(l2_path, sep="\t", index=False)
    ssf = pd.DataFrame({"SNP": ld["SNP"], "Z": rng.normal(size=m),
                        "N": 5000.0})
    ss_path = str(tmp_path / "x.sumstats")
    ssf.to_csv(ss_path, sep="\t", index=False)
    out = estimate_h2(ss_path, l2_path, n_blocks=20,
                      samp_prev=0.4, pop_prev=0.05)
    assert "hsq.liability" in out["additive"]
    assert "hsq.liability.std" in out["dominant"]


def test_one_stage_strategy_recovers_signal():
    # the reference declares `one-stg` but raises NotImplementedError
    # (nldsc/h2/routine.py:43-44); we implement it as a joint [L2, L2D]
    # 2-annotation fit.  Simulate chisq with known additive/dominance h2
    # and check the joint estimator recovers both partitions.
    import pandas as pd

    from nldsc_jax.config import H2Config
    from nldsc_jax.h2.pipeline import estimate_h2_frames

    rng = np.random.default_rng(2)
    m, n_ind = 8000, 50000.0
    M, MD = 6000, 3000
    h2_add, h2_dom = 0.4, 0.1
    l2 = rng.uniform(1, 30, m)
    l2d = rng.uniform(0.5, 10, m)
    expect = 1.0 + n_ind * (h2_add * l2 / M + h2_dom * l2d / MD)
    chisq = expect * rng.chisquare(1, m)
    ld = pd.DataFrame({"SNP": [f"rs{i}" for i in range(m)],
                       "L2": l2, "L2D": l2d})
    ssf = pd.DataFrame({"SNP": ld["SNP"], "Z": np.sqrt(chisq),
                        "N": n_ind})
    cfg = H2Config(strategy="one-stg", n_blocks=50, chisq_max=1e9)
    out = estimate_h2_frames(ssf, ld, M, MD, cfg)
    s = out["summary"]
    assert s["strategy"] == "one-stg"
    assert abs(s["additive"]["hsq"] - h2_add) < 4 * s["additive"]["hsq.std"]
    assert abs(s["dominant"]["hsq"] - h2_dom) < 4 * s["dominant"]["hsq.std"]
    assert s["additive"]["hsq.std"] > 0 and s["dominant"]["hsq.std"] > 0
    # the joint fit shares one intercept between partitions
    assert s["additive"]["intercept"] == s["dominant"]["intercept"]


def test_h2_config_validation():
    from nldsc_jax.config import H2Config
    from nldsc_jax.core.errors import NLDSCParameterError

    with pytest.raises(NLDSCParameterError):
        H2Config(strategy="bogus")
    with pytest.raises(NLDSCParameterError):
        H2Config(n_blocks=1)


def test_hsq_partitioned_api(ref_reg):
    rng = np.random.default_rng(77)
    m, p = 6000, 3
    x = rng.uniform(1, 30, (m, p))
    w = x.sum(axis=1, keepdims=True)
    N = np.full((m, 1), 15000.0)
    M = np.array([[3000.0, 2000.0, 1000.0]])
    coefs = np.array([0.2 / 3000, 0.1 / 2000, 0.05 / 1000])
    expect = 1 + 15000 * (x @ coefs)
    chisq = (expect * rng.chisquare(1, m)).clip(1e-8).reshape(m, 1)

    from nldsc_jax.h2.regression import hsq_partitioned

    ref = ref_reg.HSQAdditive(chisq, x, w, N, M, n_blocks=30, two_step=None)
    with jax.enable_x64(True):
        ours = hsq_partitioned(chisq, x, w, N, M, n_blocks=30)
    np.testing.assert_allclose(np.asarray(ours.category.value),
                               np.ravel(ref.category.value), rtol=1e-9)
    np.testing.assert_allclose(np.ravel(ours.proportion.value),
                               np.ravel(ref.proportion.value), rtol=1e-9)
    assert np.asarray(ours.enrichment).shape == (3,)


def test_partitioned_reader_and_pipeline(tmp_path):
    # build a 3-annotation .L2 with per-annotation .M_5_50 sidecar, plus a
    # separate single-column weights file, and run the partitioned CLI path
    import pandas as pd

    from nldsc_jax.h2.pipeline import estimate_h2_partitioned
    from nldsc_jax.io.ldscores import read_ld_scores_partitioned

    rng = np.random.default_rng(11)
    m, n_ind = 6000, 40000.0
    M = np.array([3000.0, 2000.0, 1000.0])
    coefs = np.array([0.3 / 3000, 0.15 / 2000, 0.05 / 1000])
    x = rng.uniform(1, 30, (m, 3))
    snp = [f"rs{i}" for i in range(m)]
    ld = pd.DataFrame({"CHR": 22, "SNP": snp, "BP": np.arange(m) * 500,
                       "base.L2": x[:, 0], "coding.L2": x[:, 1],
                       "enhancer.L2": x[:, 2]})
    l2_path = tmp_path / "part.L2"
    ld.to_csv(l2_path, sep="\t", index=False)
    pd.DataFrame({"base.L2": [M[0]], "coding.L2": [M[1]],
                  "enhancer.L2": [M[2]]}).to_csv(
        l2_path.with_suffix(".M_5_50"), sep="\t", index=False)
    # weights: plain genome-wide L2
    w = pd.DataFrame({"CHR": 22, "SNP": snp, "BP": np.arange(m) * 500,
                      "L2": x.sum(axis=1)})
    w_path = tmp_path / "w.L2"
    w.to_csv(w_path, sep="\t", index=False)
    pd.DataFrame({"M": [m], "MD": [0]}).to_csv(
        w_path.with_suffix(".M_5_50"), sep="\t", index=False)

    scores, m_annot, annots = read_ld_scores_partitioned(str(l2_path))
    assert annots == ["base.L2", "coding.L2", "enhancer.L2"]
    np.testing.assert_allclose(np.ravel(m_annot), M)

    expect = 1.0 + n_ind * (x @ coefs)
    chisq = np.clip(expect * rng.chisquare(1, m), 1e-8, None)
    ss = pd.DataFrame({"SNP": snp, "Z": np.sqrt(chisq), "N": n_ind})
    ss_path = tmp_path / "t.sumstats"
    ss.to_csv(ss_path, sep="\t", index=False)

    out = estimate_h2_partitioned(
        str(ss_path), str(l2_path), str(w_path), n_blocks=40,
        chisq_max=1e9, save_to_json=str(tmp_path / "h2.json"))
    total_true = 0.3 + 0.15 + 0.05
    assert abs(out["total"]["hsq"] - total_true) < 4 * out["total"]["hsq.std"]
    base = out["annotations"]["base.L2"]
    assert abs(base["hsq"] - 0.3) < 4 * base["hsq.std"]
    props = [a["prop"] for a in out["annotations"].values()]
    assert abs(sum(props) - 1.0) < 1e-9
    assert (tmp_path / "h2.json").exists()


def test_partitioned_reader_headerless_m(tmp_path):
    # ldsc-style headerless .M row of p numbers
    import pandas as pd

    from nldsc_jax.io.ldscores import read_ld_scores_partitioned

    rng = np.random.default_rng(3)
    m = 100
    ld = pd.DataFrame({"CHR": 1, "SNP": [f"rs{i}" for i in range(m)],
                       "BP": np.arange(m), "a.L2": rng.uniform(1, 5, m),
                       "b.L2": rng.uniform(1, 5, m)})
    p = tmp_path / "x.L2"
    ld.to_csv(p, sep="\t", index=False)
    with open(p.with_suffix(".M_5_50"), "w") as f:
        f.write("70\t30\n")
    scores, m_annot, annots = read_ld_scores_partitioned(str(p))
    np.testing.assert_allclose(np.ravel(m_annot), [70.0, 30.0])
    # mismatched count errors out
    with open(p.with_suffix(".M_5_50"), "w") as f:
        f.write("70\t30\t5\n")
    with pytest.raises(ValueError, match="counts"):
        read_ld_scores_partitioned(str(p))
