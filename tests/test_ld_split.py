"""Split-missing engine (ld_split.py): parity vs oracle and global engine.

The split engine must be indistinguishable from the global 8-matmul
missing path: exact-integer S-matrices feed the same epilogue algebra,
so counters (including the value-dependent WSE) must match EXACTLY and
the f32 score sums to summation-order ulps.
"""

import numpy as np
import pytest

from nldsc_jax.config import LDConfig
from nldsc_jax.ld.oracle import oracle_ld
from nldsc_jax.ld.pipeline import compute_ld_scores

from test_ld_device import assert_ld_parity, make_config
from utils import adversarial_genotypes, make_positions, random_genotypes


def row_level_missing(rng, m, n, row_frac=0.05, entry_rate=0.1):
    """Genotypes where only ``row_frac`` of SNPs carry missing entries."""
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    rows = rng.choice(m, size=max(1, int(m * row_frac)), replace=False)
    for r in rows:
        miss = rng.random(n) < entry_rate
        g[r] = np.where(miss, np.int8(-1), g[r])
    return g


def test_split_auto_vs_oracle(rng):
    """Row-concentrated missing auto-selects the split engine; full parity."""
    m, n = 300, 256
    g = row_level_missing(rng, m, n, row_frac=0.04)
    pos = make_positions(m, spacing=500, jitter_rng=rng)
    cfg = make_config(block_size=48)         # auto split (frac ~4%)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_split_forced_high_contamination_vs_oracle(rng):
    """split_missing=True with EVERY row contaminated stresses the
    correction algebra on 100% of pairs."""
    m, n = 180, 200
    g = random_genotypes(rng, m, n, missing_rate=0.05)
    assert ((g < 0).any(axis=1)).mean() > 0.9
    pos = make_positions(m, spacing=900, jitter_rng=rng)
    cfg = make_config(block_size=32, split_missing=True)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


@pytest.mark.parametrize("row_frac", [0.02, 0.2])
def test_split_matches_global_engine(rng, row_frac):
    """Counters exact-equal, scores ulp-equal vs the 8-matmul engine."""
    m, n = 256, 192
    g = row_level_missing(rng, m, n, row_frac=row_frac, entry_rate=0.3)
    pos = make_positions(m, spacing=650, jitter_rng=rng)
    split = compute_ld_scores(
        g, pos, make_config(block_size=64, split_missing=True))
    glob = compute_ld_scores(
        g, pos, make_config(block_size=64, split_missing=False))
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(split[k], glob[k], err_msg=k)
    np.testing.assert_allclose(split["l2"], glob["l2"], rtol=1e-5,
                               atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(split["l2d"], glob["l2d"], rtol=1e-5,
                               atol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(split["l2"]), np.isnan(glob["l2"]))


def test_split_adversarial_rows(rng):
    """Poison (all-missing), monomorphic, skip sentinels, heavy missing."""
    n = 160
    base = random_genotypes(rng, 40, n, missing_rate=0.0)
    adv = adversarial_genotypes(rng, n)
    allmiss = np.full((1, n), -1, dtype=np.int8)
    g = np.concatenate([base[:20], adv, allmiss, base[20:]]).astype(np.int8)
    m = g.shape[0]
    pos = make_positions(m, spacing=400, jitter_rng=rng, skip_idx=(3, 25))
    cfg = make_config(block_size=16, split_missing=True, maf_thr=0.01)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_split_streaming_matches_dense_and_oracle(tmp_path, rng):
    """Out-of-core split engine (split_corrections on chunk bands with
    ownership masking): row-sparse
    missing data auto-selects it; results match the in-core split engine
    and the oracle, across chunk sizes (incl. halo > chunk)."""
    from nldsc_jax.io.plink import BedReader, write_plink
    from nldsc_jax.ld.streaming import compute_ld_scores_streaming

    m, n = 400, 180
    g = row_level_missing(rng, m, n, row_frac=0.05, entry_rate=0.2)
    pos = make_positions(m, spacing=600, jitter_rng=rng)
    prefix = write_plink(tmp_path / "sp", g, bp=pos.astype(np.int64))
    bed = BedReader(prefix + ".bed", m, n)
    cfg = make_config(block_size=16, ld_wind=8000)
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    for chunk in (64, 128):
        res = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                          chunk_rows=chunk)
        assert_ld_parity(res, ora)
        for k in ("l2_ws", "l2d_ws", "l2d_wse"):
            np.testing.assert_array_equal(res[k], dense[k],
                                          err_msg=f"{k}@{chunk}")
        np.testing.assert_allclose(res["l2"], dense["l2"], rtol=1e-5,
                                   atol=1e-5, equal_nan=True)
        np.testing.assert_allclose(res["l2d"], dense["l2d"], rtol=1e-5,
                                   atol=1e-5, equal_nan=True)


def test_split_streaming_resume(tmp_path, rng):
    """Split-mode streaming checkpoints/resumes like the global engine,
    and a checkpoint written by the global engine refuses to resume under
    split (engine name pinned in the meta)."""
    from nldsc_jax.io.plink import BedReader, write_plink
    from nldsc_jax.ld.streaming import compute_ld_scores_streaming

    m, n = 320, 150
    g = row_level_missing(rng, m, n, row_frac=0.04, entry_rate=0.25)
    pos = make_positions(m, spacing=700, jitter_rng=rng)
    prefix = write_plink(tmp_path / "spr", g, bp=pos.astype(np.int64))
    bed = BedReader(prefix + ".bed", m, n)
    cfg = make_config(block_size=16, ld_wind=6000)
    resume = str(tmp_path / "ck")
    full = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                       chunk_rows=64, resume_path=resume)
    import os
    shards = sorted(f for f in os.listdir(resume) if f.startswith("chunk_"))
    assert len(shards) >= 3
    for f in shards[-2:]:
        os.remove(os.path.join(resume, f))
    resumed = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                          chunk_rows=64, resume_path=resume)
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(resumed[k], full[k], rtol=1e-6,
                                   atol=1e-6, equal_nan=True)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(resumed[k], full[k], err_msg=k)

    # a global-engine checkpoint must refuse under the split engine
    cfg_glob = make_config(block_size=16, ld_wind=6000, split_missing=False)
    with pytest.raises(ValueError, match="different parameters"):
        compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg_glob,
                                    chunk_rows=64, resume_path=resume)


def test_compact_missing_rows_matches_materialized(rng):
    """compact_missing_rows(raw, miss_idx) must equal the materialized
    indicator matrix's gathered rows BITWISE (including padding rows,
    which are all-missing under pad_val=-1)."""
    import jax.numpy as jnp

    from nldsc_jax.ld.ld_int8 import preprocess_int8
    from nldsc_jax.ld.ld_split import compact_missing_rows

    m, n = 96, 130
    g = random_genotypes(rng, m, n, missing_rate=0.1)
    g_pad = np.full((128, 256), -1, dtype=np.int8)
    g_pad[:m, :n] = g
    g_dev = jnp.asarray(g_pad)
    pre = preprocess_int8(g_dev, jnp.ones(128, bool), jnp.float32(0.01),
                          n_samples=n)
    miss_idx = np.flatnonzero((g_pad < 0).any(axis=1)).astype(np.int32)
    miss_idx = np.concatenate([miss_idx, np.full(8, 127, np.int32)])
    m_c = compact_missing_rows(g_dev, jnp.asarray(miss_idx))
    np.testing.assert_array_equal(np.asarray(m_c),
                                  np.asarray(pre["m"])[miss_idx])


def test_split_unusable_contaminated_rows_only(rng):
    """Missing confined to MAF-dropped rows: clean epilogue is exact and
    the pipeline must notice (use_missing demotion path)."""
    m, n = 120, 150
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    # make two rows ultra-rare (dropped at maf_thr=0.05) and contaminated
    for r in (10, 70):
        g[r] = 0
        g[r, :3] = 1
        g[r, 5:20] = -1
    pos = make_positions(m, spacing=800, jitter_rng=rng)
    cfg = make_config(block_size=24, maf_thr=0.05)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)
