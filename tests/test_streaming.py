"""Streaming (out-of-core) engine vs dense path + checkpoint/resume."""

import numpy as np
import pytest

from nldsc_jax.config import LDConfig
from nldsc_jax.io.plink import BedReader, write_plink
from nldsc_jax.ld.pipeline import compute_ld_scores
from nldsc_jax.ld.streaming import compute_ld_scores_streaming

from utils import make_positions, random_genotypes


def _setup(tmp_path, rng, m=300, n=180):
    g = random_genotypes(rng, m, n, missing_rate=0.04)
    pos = make_positions(m, spacing=800, jitter_rng=rng)
    prefix = write_plink(tmp_path / "stream", g, bp=pos.astype(np.int64))
    bed = BedReader(prefix + ".bed", m, n)
    return g, pos, bed


def _assert_same(a, b):
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("use_int8", [True, False])
def test_streaming_matches_dense(tmp_path, rng, use_int8):
    g, pos, bed = _setup(tmp_path, rng)
    cfg = LDConfig(ld_wind=8000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16,
                   use_int8=use_int8, symmetric=False)
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg)
    for chunk in (64, 96, 512):
        streamed = compute_ld_scores_streaming(
            bed, pos.astype(np.float64), cfg, chunk_rows=chunk)
        _assert_same(streamed, dense)


def test_streaming_int8_no_missing(tmp_path, rng):
    g = random_genotypes(rng, 200, 120, missing_rate=0.0)
    pos = make_positions(200, spacing=900)
    from nldsc_jax.io.plink import write_plink

    prefix = write_plink(tmp_path / "nomiss", g, bp=pos.astype(np.int64))
    bed = BedReader(prefix + ".bed", 200, 120)
    cfg = LDConfig(ld_wind=7000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    from nldsc_jax.ld.oracle import oracle_ld

    streamed = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                           chunk_rows=64)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr,
                    cfg.rsq_thr)
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(streamed[k], ora[k], rtol=3e-6, atol=3e-6,
                                   equal_nan=True, err_msg=k)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(streamed[k], ora[k], err_msg=k)


def test_streaming_resume(tmp_path, rng):
    g, pos, bed = _setup(tmp_path, rng)
    cfg = LDConfig(ld_wind=5000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    resume = str(tmp_path / "ckpt")
    full = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                       chunk_rows=64, resume_path=resume)

    # per-chunk shard files + meta were written
    import os
    shards = sorted(f for f in os.listdir(resume) if f.startswith("chunk_"))
    assert len(shards) >= 2 and os.path.exists(os.path.join(resume, "meta.json"))

    # the rowmiss bitmap was cached (r5: skips the full-.bed scan on
    # resume — ~110 s at UKB scale) and is keyed by the .bed identity
    rm = np.load(os.path.join(resume, "rowmiss.npz"), allow_pickle=False)
    assert rm["rowmiss"].shape == (g.shape[0],)
    np.testing.assert_array_equal(rm["rowmiss"], (g < 0).any(axis=1))

    # simulate a partial run: delete the last two chunk shards
    for f in shards[-2:]:
        os.remove(os.path.join(resume, f))
    resumed = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                          chunk_rows=64, resume_path=resume)
    _assert_same(resumed, full)

    # a CORRUPTED/stale cached bitmap keyed to a different .bed identity
    # is ignored (rescanned), not trusted
    np.savez(os.path.join(resume, "rowmiss.npz"),
             rowmiss=~rm["rowmiss"], bed_path="/nowhere", bed_bytes=0)
    resumed2 = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                           chunk_rows=64, resume_path=resume)
    _assert_same(resumed2, full)

    # a geometry mismatch is rejected instead of silently mixing shards
    import pytest
    with pytest.raises(ValueError, match="different parameters"):
        compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                    chunk_rows=128, resume_path=resume)

    # so is ANY filter-threshold change (a stale checkpoint must never
    # silently corrupt an .L2) ...
    for field, val in (("maf_thr", 0.05), ("std_thr", 1e-3),
                       ("rsq_thr", 0.05), ("ld_wind", 4000)):
        cfg_bad = LDConfig(**{**dict(
            ld_wind=5000, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
            rsq_thr=1e-3, block_size=16), field: val})
        with pytest.raises(ValueError, match="different parameters"):
            compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg_bad,
                                        chunk_rows=64, resume_path=resume)

    # ... and a different .bed file (identity pinned by path+size)
    (tmp_path / "other").mkdir()
    g2, pos2, bed2 = _setup(tmp_path / "other", rng)
    with pytest.raises(ValueError, match="different parameters"):
        compute_ld_scores_streaming(bed2, pos2.astype(np.float64), cfg,
                                    chunk_rows=64, resume_path=resume)


def test_streaming_resume_noncontiguous_symmetric(tmp_path, rng):
    """Symmetric-mode resume from a NON-CONTIGUOUS checkpoint set: column
    credits flow forward chunk-to-chunk, so only the contiguous prefix is
    reusable — orphan chunks after a gap must be recomputed and the carry
    realigned at the resume point (streaming.py orphan-pruning)."""
    g, pos, bed = _setup(tmp_path, rng, m=400)
    cfg = LDConfig(ld_wind=9000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    resume = str(tmp_path / "ckpt_gap")
    full = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                       chunk_rows=64, resume_path=resume)
    import os
    shards = sorted(f for f in os.listdir(resume) if f.startswith("chunk_"))
    assert len(shards) >= 4
    # punch a hole in the middle: chunks after it are orphans
    os.remove(os.path.join(resume, shards[1]))
    resumed = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                          chunk_rows=64, resume_path=resume)
    _assert_same(resumed, full)
    # ... and resume with NO reusable prefix (chunk 0 missing)
    shards = sorted(f for f in os.listdir(resume) if f.startswith("chunk_"))
    os.remove(os.path.join(resume, shards[0]))
    resumed2 = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                           chunk_rows=64, resume_path=resume)
    _assert_same(resumed2, full)


def test_streaming_annot_symmetric_resume(tmp_path, rng):
    """Partitioned symmetric streaming checkpoints the annot credit tails
    (tail_a) and realigns them on resume."""
    m, n, p = 320, 150, 2
    g = random_genotypes(rng, m, n, missing_rate=0.03)
    pos = make_positions(m, spacing=700, jitter_rng=rng)
    annot = np.column_stack([np.ones(m), (rng.random(m) < 0.4)]).astype(
        np.float64)[:, :p]
    prefix = write_plink(tmp_path / "sar", g, bp=pos.astype(np.int64))
    bed = BedReader(prefix + ".bed", m, n)
    cfg = LDConfig(ld_wind=8000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    resume = str(tmp_path / "ckpt_annot")
    full = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                       chunk_rows=64, annot=annot,
                                       resume_path=resume)
    import os
    shards = sorted(f for f in os.listdir(resume) if f.startswith("chunk_"))
    assert len(shards) >= 3
    for f in shards[-2:]:
        os.remove(os.path.join(resume, f))
    resumed = compute_ld_scores_streaming(bed, pos.astype(np.float64), cfg,
                                          chunk_rows=64, annot=annot,
                                          resume_path=resume)
    _assert_same(resumed, full)
    np.testing.assert_allclose(resumed["l2_annot"], full["l2_annot"],
                               rtol=1e-6, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(resumed["l2d_annot"], full["l2d_annot"],
                               rtol=1e-6, atol=1e-6, equal_nan=True)


def test_streaming_multi_device_matches_dense(tmp_path, rng):
    # round-robin chunk dispatch over the 8 virtual CPU devices must be
    # bitwise-identical to the single-device streaming pass
    import jax

    g, pos, bed = _setup(tmp_path, rng, m=400)
    cfg = LDConfig(ld_wind=8000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg)
    devs = jax.devices()
    assert len(devs) >= 2
    multi = compute_ld_scores_streaming(
        bed, pos.astype(np.float64), cfg, chunk_rows=64, devices=devs)
    _assert_same(multi, dense)
    # with a checkpoint directory too
    ck = str(tmp_path / "mdck")
    multi_ck = compute_ld_scores_streaming(
        bed, pos.astype(np.float64), cfg, chunk_rows=64, devices=devs,
        resume_path=ck)
    _assert_same(multi_ck, dense)


def test_streaming_grid_matches_dense(tmp_path, rng):
    # the 3-axis composition: M streamed from disk, chunks round-robined
    # over the grid's snp rows, each row sample-sharding its chunk band.
    # Sample psums are exact integer sums and chunk geometry is
    # layout-independent, so results must be BITWISE identical across
    # grid layouts and equal to the dense engine to summation ulps.
    from nldsc_jax.parallel.grid_sharded import grid_mesh

    g, pos, bed = _setup(tmp_path, rng, m=400)
    cfg = LDConfig(ld_wind=8000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg)
    res = {}
    for shape in ((4, 2), (2, 4)):
        res[shape] = compute_ld_scores_streaming(
            bed, pos.astype(np.float64), cfg, chunk_rows=64,
            grid=grid_mesh(*shape))
        _assert_same(res[shape], dense)
    for k in ("l2", "l2d"):
        np.testing.assert_array_equal(res[(4, 2)][k], res[(2, 4)][k],
                                      err_msg=f"{k} not layout-invariant")

    # grid composes with checkpoint/resume like every other layout
    ck = str(tmp_path / "gridck")
    ck_res = compute_ld_scores_streaming(
        bed, pos.astype(np.float64), cfg, chunk_rows=64,
        grid=grid_mesh(4, 2), resume_path=ck)
    _assert_same(ck_res, dense)

    # mutual exclusions
    import jax
    with pytest.raises(ValueError, match="mutually exclusive"):
        compute_ld_scores_streaming(
            bed, pos.astype(np.float64), cfg, chunk_rows=64,
            grid=grid_mesh(4, 2), devices=jax.devices())


def test_streaming_symmetric_wide_halo(tmp_path, rng):
    # symmetric streaming with halo spanning MULTIPLE chunks: column
    # credits must carry across 3+ chunk boundaries
    g, pos, bed = _setup(tmp_path, rng, m=350)
    cfg = LDConfig(ld_wind=30000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    assert cfg.symmetric is None  # auto -> symmetric
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg)
    for chunk in (16, 32, 512):
        streamed = compute_ld_scores_streaming(
            bed, pos.astype(np.float64), cfg, chunk_rows=chunk)
        _assert_same(streamed, dense)
    # resume mid-run: delete some trailing shards, carry must rebuild
    ck = str(tmp_path / "symck")
    full = compute_ld_scores_streaming(
        bed, pos.astype(np.float64), cfg, chunk_rows=16, resume_path=ck)
    import os
    shards = sorted(f for f in os.listdir(ck) if f.startswith("chunk_"))
    assert len(shards) > 6
    for f in shards[-5:]:
        os.remove(os.path.join(ck, f))
    # also orphan a middle shard: sym resume must keep only the prefix
    os.remove(os.path.join(ck, shards[3]))
    resumed = compute_ld_scores_streaming(
        bed, pos.astype(np.float64), cfg, chunk_rows=16, resume_path=ck)
    _assert_same(resumed, full)


def test_streaming_band_retention_bitwise(tmp_path, rng):
    """Band-tail retention (r5) assembles chunk bands from the previous
    chunk's device-resident packed rows instead of re-transferring the
    halo overlap.  The assembled bytes are identical by construction —
    assert BITWISE-equal outputs against the retention-off path
    (split_missing=False skips the rowmiss scan, which gates retention;
    with clean data both configs run the exact same clean kernels)."""
    m, n = 300, 180
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    pos = make_positions(m, spacing=800, jitter_rng=rng)
    prefix = write_plink(tmp_path / "ret", g, bp=pos.astype(np.int64))
    bed = BedReader(prefix + ".bed", m, n)
    base = dict(ld_wind=5000, wind_metric="bp", maf_thr=0.01,
                std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    on = compute_ld_scores_streaming(
        bed, pos.astype(np.float64), LDConfig(**base), chunk_rows=64)
    off = compute_ld_scores_streaming(
        bed, pos.astype(np.float64), LDConfig(**base, split_missing=False),
        chunk_rows=64)
    for k in on:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_streaming_symmetric_retention_chunk_sweep(tmp_path, rng, chunk):
    """Symmetric streaming (band-tail retention active) vs the dense
    engine across chunk sizes straddling the halo width — chunk 16 puts
    halo > chunk_rows, so a retained band's tail spans MULTIPLE past
    chunks' rows; the assembly must still reproduce the exact band."""
    g, pos, bed = _setup(tmp_path, rng)
    cfg = LDConfig(ld_wind=9000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg)
    streamed = compute_ld_scores_streaming(
        bed, pos.astype(np.float64), cfg, chunk_rows=chunk)
    _assert_same(streamed, dense)
