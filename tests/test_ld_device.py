"""Device (XLA banded) path vs float64 oracle parity."""

import numpy as np
import pytest

from nldsc_jax.config import LDConfig
from nldsc_jax.ld.oracle import oracle_ld
from nldsc_jax.ld.pipeline import compute_ld_scores
from nldsc_jax.ld import windows

from utils import adversarial_genotypes, make_positions, random_genotypes


def assert_ld_parity(res, ora, rtol=2e-5, atol=2e-4):
    np.testing.assert_allclose(res["l2"], ora["l2"], rtol=rtol, atol=atol,
                               equal_nan=True)
    np.testing.assert_allclose(res["l2d"], ora["l2d"], rtol=rtol, atol=atol,
                               equal_nan=True)
    np.testing.assert_allclose(res["maf"], ora["maf"], rtol=1e-6, atol=1e-7,
                               equal_nan=True)
    np.testing.assert_allclose(res["residuals_std"], ora["residuals_std"],
                               rtol=1e-4, atol=1e-6, equal_nan=True)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(res[k], ora[k], err_msg=k)


def make_config(**kw):
    kw.setdefault("ld_wind", 5000)
    kw.setdefault("wind_metric", "bp")
    kw.setdefault("maf_thr", 0.01)
    kw.setdefault("std_thr", 1e-4)
    kw.setdefault("rsq_thr", 1e-3)
    kw.setdefault("block_size", 64)
    return LDConfig(**kw)


@pytest.mark.parametrize("symmetric", [True, False])
def test_parity_basic(rng, symmetric):
    g = random_genotypes(rng, 200, 300, missing_rate=0.03)
    pos = make_positions(200, spacing=777, jitter_rng=rng)
    cfg = make_config(symmetric=symmetric)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


@pytest.mark.parametrize("symmetric", [True, False])
def test_parity_asymmetric_windows(rng, symmetric):
    # irregular spacing -> asymmetric per-SNP windows stress right_k
    g = random_genotypes(rng, 180, 220, missing_rate=0.02)
    gaps = rng.choice([10, 100, 3000, 8000], size=180)
    pos = np.cumsum(gaps).astype(np.float64)
    cfg = make_config(ld_wind=6000, block_size=16, symmetric=symmetric)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_parity_adversarial(rng):
    adv = adversarial_genotypes(rng, 256)
    g = np.concatenate([random_genotypes(rng, 40, 256, missing_rate=0.05),
                        adv,
                        random_genotypes(rng, 40, 256, missing_rate=0.05)])
    pos = make_positions(len(g), spacing=1000, skip_idx=(3, 50))
    cfg = make_config(ld_wind=20000, maf_thr=1e-5, block_size=32)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_parity_wide_window_and_odd_sizes(rng):
    # window spanning everything; M and N not multiples of block/128
    g = random_genotypes(rng, 131, 99, missing_rate=0.08)
    pos = make_positions(131, spacing=10)
    cfg = make_config(ld_wind=1e6, block_size=48)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_parity_cm_metric(rng):
    g = random_genotypes(rng, 120, 200, missing_rate=0.0)
    cm = np.sort(rng.uniform(0, 3.0, size=120))
    cfg = make_config(ld_wind=0.5, wind_metric="cm", block_size=64)
    res = compute_ld_scores(g, cm, cfg)
    ora = oracle_ld(g, cm, 0.5, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_window_bounds_match_predicate(rng):
    pos = np.sort(rng.uniform(0, 1e5, size=500))
    pos[123] = -1.0  # sentinel
    lo, hi, pos_ok = windows.window_bounds(pos, 2500.0)
    filled, _ = windows.fill_skipped_positions(pos)
    for i in range(500):
        in_win = np.abs(filled - filled[i]) <= 2500.0
        assert lo[i] == np.flatnonzero(in_win)[0]
        assert hi[i] == np.flatnonzero(in_win)[-1]


def test_unsorted_positions_rejected():
    from nldsc_jax.core.errors import NLDSCDataError

    pos = np.array([1.0, 3.0, 2.0])
    with pytest.raises(NLDSCDataError):
        windows.window_bounds(pos, 10.0)


def test_device_window_boundary_inclusive(rng):
    # pairs exactly at distance == window are INCLUDED (tools.h:45-46)
    g = random_genotypes(rng, 3, 256, missing_rate=0.0)
    pos = np.array([0.0, 1000.0, 2000.0])
    cfg = make_config(ld_wind=1000, block_size=8)
    res = compute_ld_scores(g, pos, cfg)
    assert res["l2_ws"][0] == 1 and res["l2_ws"][1] == 2


def test_device_sample_permutation_invariance(rng):
    g = random_genotypes(rng, 40, 200, missing_rate=0.05)
    pos = make_positions(40, spacing=900)
    perm = rng.permutation(200)
    cfg = make_config(block_size=8)
    a = compute_ld_scores(g, pos, cfg)
    b = compute_ld_scores(g[:, perm], pos, cfg)
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("use_int8", [True, False])
def test_constant_cm_positions(rng, use_int8):
    # real .bim files often carry an all-zero CM column: every pair is
    # within any window — the full-matrix degenerate case
    g = random_genotypes(rng, 72, 130, missing_rate=0.02)
    cm = np.zeros(72)
    cfg = make_config(ld_wind=1.0, wind_metric="cm", block_size=8,
                      use_int8=use_int8)
    res = compute_ld_scores(g, cm, cfg)
    ora = oracle_ld(g, cm, 1.0, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)
    usable = ~np.isnan(res["l2"])
    assert (res["l2_ws"][usable] == usable.sum() - 1).all()


@pytest.mark.parametrize("use_int8", [True, False])
def test_duplicate_bp_positions(rng, use_int8):
    # duplicated BP coordinates (multi-allelic split sites) must not break
    # the sorted-interval window logic
    g = random_genotypes(rng, 60, 100, missing_rate=0.0)
    bp = np.repeat(np.arange(1, 31) * 1000.0, 2)
    cfg = make_config(ld_wind=2000, block_size=8, use_int8=use_int8)
    res = compute_ld_scores(g, bp, cfg)
    ora = oracle_ld(g, bp, 2000, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


@pytest.mark.parametrize("use_int8", [True, False])
def test_all_missing_snp_poison(rng, use_int8):
    # reference semantics: an ALL-missing SNP has NaN mean, survives the
    # `maf <= thr` drop (NaN comparison is false), and NaN-poisons the
    # additive sum of every in-window pair; its NaN residual sd keeps it
    # out of dominance (encoder.h:99-129 with n_nans == 0)
    g = random_genotypes(rng, 12, 100, missing_rate=0.0, maf_low=0.2)
    g[5] = -1  # all missing
    pos = make_positions(12, spacing=1000)
    cfg = make_config(ld_wind=100000, block_size=8, use_int8=use_int8)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    assert_ld_parity(res, ora)
    assert np.isnan(res["l2"]).all()          # every pair poisoned
    assert np.isnan(res["maf"][5])
    assert not np.isnan(res["l2d"][0])        # dominance unaffected
    assert res["l2_ws"][0] == 11              # poison SNP still counted
