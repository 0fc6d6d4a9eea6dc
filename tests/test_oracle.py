"""Oracle semantics tests: properties the reference guarantees (SURVEY §2.3)."""

import numpy as np

from nldsc_jax.ld.oracle import oracle_ld, preprocess

from utils import adversarial_genotypes, make_positions, random_genotypes


def test_self_inclusion_and_counters(rng):
    g = random_genotypes(rng, 30, 200, missing_rate=0.0)
    pos = make_positions(30, spacing=1000)
    res = oracle_ld(g, pos, ld_wind=5000, maf_thr=1e-5, std_thr=1e-5,
                    rsq_thr=1e-3)
    usable = ~np.isnan(res["l2"])
    # l2 >= 1 - eps for usable SNPs (self term is 1.0, adjusted terms can be
    # slightly negative: 1-(n-1)/(n-2) at r=0)
    n = 200
    min_term = 1 - (n - 1) / (n - 2)
    assert (res["l2"][usable] >= 1.0 + res["l2_ws"][usable] * min_term - 1e-9).all()
    # window counters: interior SNPs see exactly 10 neighbors (±5 at 1kb)
    assert res["l2_ws"][15] == 10
    assert (res["l2d_ws"] <= res["l2_ws"]).all()
    assert (res["l2d_wse"][usable] <= res["l2d_ws"][usable]).all()


def test_window_boundary_inclusive(rng):
    # dist == window must be INCLUDED (tools.h:45-46)
    g = random_genotypes(rng, 3, 500, missing_rate=0.0)
    pos = np.array([0.0, 1000.0, 2000.0])
    res = oracle_ld(g, pos, ld_wind=1000, maf_thr=1e-5, std_thr=1e-5,
                    rsq_thr=0.0)
    assert res["l2_ws"][0] == 1   # exactly at distance 1000 -> included
    assert res["l2_ws"][1] == 2


def test_position_sentinel_and_maf_drop(rng):
    g = random_genotypes(rng, 10, 300, missing_rate=0.0, maf_low=0.2)
    g[4] = rng.binomial(2, 0.001, size=300)  # will fail MAF threshold
    pos = make_positions(10, skip_idx=(7,))
    res = oracle_ld(g, pos, ld_wind=100000, maf_thr=0.05, std_thr=1e-5,
                    rsq_thr=1e-3)
    # position-skipped: everything NaN/-1, including MAF
    assert np.isnan(res["l2"][7]) and np.isnan(res["maf"][7])
    assert res["l2_ws"][7] == -1
    # MAF-dropped: MAF recorded, everything else NaN/-1
    assert np.isnan(res["l2"][4]) and not np.isnan(res["maf"][4])
    assert res["l2_ws"][4] == -1
    assert np.isnan(res["residuals_std"][4])
    # neither participates as a neighbor
    assert res["l2_ws"][5] == 7  # 10 - self - skipped - dropped


def test_adversarial_rows(rng):
    g = adversarial_genotypes(rng, 400)
    pos = make_positions(len(g))
    res = oracle_ld(g, pos, ld_wind=1e6, maf_thr=1e-5, std_thr=1e-5,
                    rsq_thr=1e-3)
    # monomorphic rows: maf == 0 <= thr -> dropped
    assert np.isnan(res["l2"][0]) and np.isnan(res["l2"][1])
    assert res["maf"][0] == 0.0
    # all-het row: maf=0.5 usable but sd=0 poisons additive sums of peers
    assert np.isnan(res["l2"][2])
    assert np.isnan(res["l2"][4])  # poisoned neighbor
    # ... but NOT the dominance sum of peers (NaN rstd fails std filter)
    assert not np.isnan(res["l2d"][4])
    assert np.isnan(res["residuals_std"][2])


def test_missingness_imputation(rng):
    # a SNP with missing values must use MAF from non-missing only
    g = np.array([[0, 1, 2, -1, -1, 1, 0, 2, 1, 0]] * 2, dtype=np.int8)
    pre = preprocess(g, make_positions(2), maf_thr=1e-5)
    np.testing.assert_allclose(pre.maf[0], (7 / 8) / 2)
    # standardized rows have mean ~0, pop-sd ~1
    np.testing.assert_allclose(pre.add_std[0].mean(), 0, atol=1e-12)
    np.testing.assert_allclose((pre.add_std[0] ** 2).mean(), 1, atol=1e-12)


def test_sample_permutation_invariance(rng):
    # SURVEY Q7: statistics are invariant to any fixed sample permutation
    g = random_genotypes(rng, 12, 150, missing_rate=0.05)
    pos = make_positions(12)
    perm = rng.permutation(150)
    a = oracle_ld(g, pos, 5000, 0.01, 1e-4, 1e-3)
    b = oracle_ld(g[:, perm], pos, 5000, 0.01, 1e-4, 1e-3)
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, equal_nan=True)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(a[k], b[k])
