"""Sharded (8 virtual devices) vs single-device LD parity."""

import numpy as np
import pytest

import jax

from nldsc_jax.config import LDConfig
from nldsc_jax.ld.oracle import oracle_ld
from nldsc_jax.ld.pipeline import compute_ld_scores
from nldsc_jax.parallel import ld_scores_sharded, snp_mesh

from test_ld_device import assert_ld_parity
from utils import adversarial_genotypes, make_positions, random_genotypes


def _cfg(**kw):
    kw.setdefault("ld_wind", 5000)
    kw.setdefault("wind_metric", "bp")
    kw.setdefault("maf_thr", 0.01)
    kw.setdefault("std_thr", 1e-4)
    kw.setdefault("rsq_thr", 1e-3)
    kw.setdefault("block_size", 16)
    return LDConfig(**kw)


def test_sharded_matches_dense(rng):
    assert len(jax.devices()) == 8
    g = random_genotypes(rng, 240, 200, missing_rate=0.03)
    pos = make_positions(240, spacing=900, jitter_rng=rng)
    cfg = _cfg()
    mesh = snp_mesh(8)
    res_s = ld_scores_sharded(g, pos, cfg, mesh)
    res_d = compute_ld_scores(g, pos, cfg)
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_allclose(res_s[k], res_d[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(res_s[k], res_d[k], err_msg=k)


def test_sharded_matches_oracle_adversarial(rng):
    adv = adversarial_genotypes(rng, 128)
    g = np.concatenate([random_genotypes(rng, 61, 128, missing_rate=0.05),
                        adv,
                        random_genotypes(rng, 61, 128, missing_rate=0.05)])
    pos = make_positions(len(g), spacing=1000, skip_idx=(2, 40))
    cfg = _cfg(ld_wind=9000, maf_thr=1e-5, block_size=8)
    res = ld_scores_sharded(g, pos, cfg, snp_mesh(8))
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_device_count_invariance(rng, n_dev):
    g = random_genotypes(rng, 130, 96, missing_rate=0.02)
    pos = make_positions(130, spacing=700)
    cfg = _cfg(ld_wind=4000, block_size=8)
    res = ld_scores_sharded(g, pos, cfg, snp_mesh(n_dev))
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_window_wider_than_shard_multihop(rng):
    # window spanning the whole chromosome: the halo needs rows from every
    # other shard (multi-hop ppermute) — degenerate but must stay correct
    g = random_genotypes(rng, 128, 64)
    pos = make_positions(128, spacing=10)  # everything within window
    cfg = _cfg(ld_wind=1e6, block_size=8)
    res = ld_scores_sharded(g, pos, cfg, snp_mesh(8))
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_halo_two_hops(rng):
    # window ~1.5 shards wide: exactly the 2-hop halo path
    g = random_genotypes(rng, 160, 80, missing_rate=0.02)
    pos = make_positions(160, spacing=1000)
    cfg = _cfg(ld_wind=30000, block_size=8)  # ±30 SNPs vs L=20 rows
    res = ld_scores_sharded(g, pos, cfg, snp_mesh(8))
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    assert_ld_parity(res, ora)


@pytest.mark.parametrize("missing_rate", [0.0, 0.05])
def test_sharded_int8_matches_oracle(rng, missing_rate):
    g = random_genotypes(rng, 160, 140, missing_rate=missing_rate)
    pos = make_positions(160, spacing=800)
    cfg = _cfg(ld_wind=6000, block_size=8, use_int8=True)
    res = ld_scores_sharded(g, pos, cfg, snp_mesh(8))
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    tol = dict(rtol=3e-6, atol=3e-6) if missing_rate == 0 else {}
    assert_ld_parity(res, ora, **tol)


@pytest.mark.parametrize("missing_rate", [0.0, 0.05])
def test_sample_sharded_matches_oracle(rng, missing_rate):
    from nldsc_jax.parallel.sample_sharded import ld_scores_sample_sharded

    g = random_genotypes(rng, 96, 300, missing_rate=missing_rate)
    pos = make_positions(96, spacing=800)
    cfg = _cfg(ld_wind=6000, block_size=16)
    res = ld_scores_sample_sharded(g, pos, cfg, snp_mesh(8))
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    tol = dict(rtol=3e-6, atol=3e-6) if missing_rate == 0 else {}
    assert_ld_parity(res, ora, **tol)


def test_sample_sharded_device_count_invariance(rng):
    from nldsc_jax.parallel.sample_sharded import ld_scores_sample_sharded

    g = random_genotypes(rng, 64, 200, missing_rate=0.02)
    pos = make_positions(64, spacing=700)
    cfg = _cfg(ld_wind=4000, block_size=8)
    a = ld_scores_sample_sharded(g, pos, cfg, snp_mesh(2))
    b = ld_scores_sample_sharded(g, pos, cfg, snp_mesh(8))
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_grid_sharded_matches_oracle(rng, shape):
    from nldsc_jax.parallel.grid_sharded import (grid_mesh,
                                                 ld_scores_grid_sharded)

    g = random_genotypes(rng, 96, 200, missing_rate=0.03)
    pos = make_positions(96, spacing=800)
    cfg = _cfg(ld_wind=6000, block_size=8)
    res = ld_scores_grid_sharded(g, pos, cfg, grid_mesh(*shape))
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_grid_sharded_no_missing_exact(rng):
    from nldsc_jax.parallel.grid_sharded import (grid_mesh,
                                                 ld_scores_grid_sharded)

    g = random_genotypes(rng, 64, 150, missing_rate=0.0)
    pos = make_positions(64, spacing=900)
    cfg = _cfg(ld_wind=5000, block_size=8)
    res = ld_scores_grid_sharded(g, pos, cfg, grid_mesh(2, 4))
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    assert_ld_parity(res, ora, rtol=3e-6, atol=3e-6)


@pytest.mark.parametrize("missing_rate", [0.0, 0.03])
def test_snp_sharded_bitwise_across_device_counts(rng, missing_rate):
    """The SNP-sharded engine is BITWISE invariant in the device count.

    Per-shard tile geometry is count-independent (j0 = local r0 always —
    the halo supplies out-of-range rows instead of shifting the band), so
    every per-row reduction runs over the same values at the same lane
    positions regardless of the mesh size.  Includes a wide window so
    column credits cross shard boundaries (multi-hop on the 8-mesh).
    """
    g = random_genotypes(rng, 384, 160, missing_rate=missing_rate)
    pos = make_positions(384, spacing=300)
    cfg = _cfg(ld_wind=20000, block_size=16)
    base = ld_scores_sharded(g, pos, cfg, snp_mesh(1))
    for nd in (2, 4, 8):
        res = ld_scores_sharded(g, pos, cfg, snp_mesh(nd))
        for k in ("l2", "l2d"):
            assert np.array_equal(res[k], base[k], equal_nan=True), (k, nd)
        for k in ("l2_ws", "l2d_ws", "l2d_wse"):
            np.testing.assert_array_equal(res[k], base[k], err_msg=f"{k}@{nd}")


@pytest.mark.parametrize("missing_rate", [0.0, 0.03])
def test_sample_sharded_bitwise_across_device_counts(rng, missing_rate):
    """Sample-axis sharding: exact integer psum of the S-matrices makes
    the epilogue inputs shard-count-independent — outputs are bitwise."""
    from nldsc_jax.parallel.sample_sharded import ld_scores_sample_sharded

    g = random_genotypes(rng, 96, 300, missing_rate=missing_rate)
    pos = make_positions(96, spacing=700)
    cfg = _cfg(ld_wind=6000, block_size=16)
    base = ld_scores_sample_sharded(g, pos, cfg, snp_mesh(1))
    for nd in (2, 8):
        res = ld_scores_sample_sharded(g, pos, cfg, snp_mesh(nd))
        for k in ("l2", "l2d"):
            assert np.array_equal(res[k], base[k], equal_nan=True), (k, nd)
        for k in ("l2_ws", "l2d_ws", "l2d_wse"):
            np.testing.assert_array_equal(res[k], base[k], err_msg=f"{k}@{nd}")


def test_sharded_counters_exact_vs_dense(rng):
    """All integer counters — including the VALUE-dependent WSE — must
    match the single-device dense engine exactly (the adjusted r² values
    feeding the threshold compare are the same exact-integer algebra);
    the f32 score sums may differ by summation-order ulps only."""
    g = random_genotypes(rng, 384, 160, missing_rate=0.03)
    pos = make_positions(384, spacing=300)
    cfg = _cfg(ld_wind=20000, block_size=16)
    dense = compute_ld_scores(g, pos, cfg)
    res = ld_scores_sharded(g, pos, cfg, snp_mesh(8))
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(res[k], dense[k], err_msg=k)
    np.testing.assert_allclose(res["l2"], dense["l2"], rtol=1e-6, atol=1e-5,
                               equal_nan=True)
    np.testing.assert_allclose(res["l2d"], dense["l2d"], rtol=1e-6,
                               atol=1e-5, equal_nan=True)


def test_sharded_packed_matches_dense(tmp_path, rng):
    # packed (2-bit) rows scattered over the mesh + device unpack == dense
    from nldsc_jax.io.plink import BedReader, write_plink

    m, n = 256, 140
    g = random_genotypes(rng, m, n, missing_rate=0.03)
    pos = make_positions(m, spacing=700, jitter_rng=rng)
    prefix = write_plink(tmp_path / "shp", g, bp=pos.astype(np.int64))
    packed = BedReader(prefix + ".bed", m, n).read_raw()

    cfg = LDConfig(ld_wind=6000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg)
    res = ld_scores_sharded(packed, pos.astype(np.float64), cfg, snp_mesh(8))
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_allclose(res[k], dense[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(res[k], dense[k], err_msg=k)
