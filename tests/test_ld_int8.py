"""Integer-exact engine vs float64 oracle — should be the TIGHTEST engine."""

import numpy as np
import pytest

from nldsc_jax.config import LDConfig
from nldsc_jax.ld.oracle import oracle_ld
from nldsc_jax.ld.pipeline import compute_ld_scores

from test_ld_device import assert_ld_parity
from utils import adversarial_genotypes, make_positions, random_genotypes


def _cfg(**kw):
    kw.setdefault("ld_wind", 5000)
    kw.setdefault("wind_metric", "bp")
    kw.setdefault("maf_thr", 0.01)
    kw.setdefault("std_thr", 1e-4)
    kw.setdefault("rsq_thr", 1e-3)
    kw.setdefault("block_size", 64)
    kw.setdefault("use_int8", True)
    return LDConfig(**kw)


@pytest.mark.parametrize("symmetric", [True, False])
def test_int8_parity_basic(rng, symmetric):
    g = random_genotypes(rng, 200, 300, missing_rate=0.03)
    pos = make_positions(200, spacing=777, jitter_rng=rng)
    cfg = _cfg(symmetric=symmetric)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    # integer-exact contraction: tighter tolerance than the f32 engines
    assert_ld_parity(res, ora, rtol=3e-6, atol=3e-6)


@pytest.mark.parametrize("symmetric", [True, False])
def test_int8_adversarial_sym(rng, symmetric):
    adv = adversarial_genotypes(rng, 128)
    g = np.concatenate([random_genotypes(rng, 45, 128, missing_rate=0.05),
                        adv,
                        random_genotypes(rng, 45, 128, missing_rate=0.0)])
    pos = make_positions(len(g), spacing=1000, skip_idx=(7,))
    cfg = _cfg(ld_wind=15000, maf_thr=1e-5, block_size=16,
               symmetric=symmetric)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_int8_no_missing_fast_path(rng):
    # no real missing -> the 2-matmul path (even with sample padding:
    # N=250 is not a multiple of 128, exercising the analytic pad term)
    g = random_genotypes(rng, 128, 250, missing_rate=0.0)
    pos = make_positions(128, spacing=500)
    cfg = _cfg(block_size=32)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora, rtol=3e-6, atol=3e-6)


def test_int8_parity_adversarial(rng):
    adv = adversarial_genotypes(rng, 256)
    g = np.concatenate([random_genotypes(rng, 40, 256, missing_rate=0.05),
                        adv,
                        random_genotypes(rng, 40, 256, missing_rate=0.05)])
    pos = make_positions(len(g), spacing=1000, skip_idx=(3, 50))
    cfg = _cfg(ld_wind=20000, maf_thr=1e-5, block_size=32)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_int8_heavy_missing(rng):
    g = random_genotypes(rng, 100, 150, missing_rate=0.4)
    pos = make_positions(100, spacing=600)
    cfg = _cfg(block_size=32)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    assert_ld_parity(res, ora)


def test_int8_sym2_direct_parity(rng):
    # the two-pass symmetric engine is kept as a measured-slower alternate
    # (scripts/time_sym2.py); pin its correctness directly
    import jax.numpy as jnp

    from nldsc_jax.ld import ld_int8, windows

    m, n, B = 192, 160, 16
    g = random_genotypes(rng, m, n, missing_rate=0.04)
    pos = make_positions(m, spacing=900, jitter_rng=rng)
    wind = 6000.0
    lo, hi, pos_ok = windows.window_bounds(pos, wind)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, m // B)
    right_k = windows.right_band_blocks(blk_hi, B)
    pre = ld_int8.preprocess_int8(jnp.asarray(g), jnp.asarray(pos_ok),
                                  jnp.float32(0.01), n_samples=n)
    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
    args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            jnp.asarray(lo), jnp.asarray(hi),
            pre["usable"], dom_ok, pre["add_sd_zero"],
            jnp.asarray(blk_lo), jnp.asarray(blk_hi), jnp.float32(1e-3))
    out = ld_int8.ld_scores_int8_sym2(
        *args, block_size=B, right_k=right_k, n_samples=n, has_missing=True)
    res = {k: np.asarray(v) for k, v in zip(
        ("l2", "l2d", "l2_ws", "l2d_ws", "l2d_wse"), out)}
    ora = oracle_ld(g, pos, wind, 0.01, 1e-4, 1e-3)
    np.testing.assert_allclose(res["l2"], ora["l2"], rtol=3e-6, atol=3e-6,
                               equal_nan=True)
    np.testing.assert_allclose(res["l2d"], ora["l2d"], rtol=3e-6, atol=3e-6,
                               equal_nan=True)
    np.testing.assert_array_equal(res["l2_ws"], ora["l2_ws"])
    np.testing.assert_array_equal(res["l2d_wse"], ora["l2d_wse"])


def test_segmented_progress_matches_single_scan(rng):
    # the percent/ETA progress path dispatches sym_scan_segment per pivot
    # segment; summed segments + finalize must equal the one-shot engine
    from nldsc_jax.config import LDConfig
    from nldsc_jax.ld.pipeline import compute_ld_scores

    g = random_genotypes(rng, 260, 200, missing_rate=0.03)
    pos = make_positions(260, spacing=700, jitter_rng=rng)
    cfg = LDConfig(ld_wind=6000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=16)
    plain = compute_ld_scores(g, pos, cfg)

    ticks = []
    seg = compute_ld_scores(g, pos, cfg,
                            progress=lambda d, t: ticks.append((d, t)))
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_allclose(seg[k], plain[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(seg[k], plain[k], err_msg=k)
    assert ticks[0] == (0, 260) and ticks[-1] == (260, 260)
    assert len(ticks) >= 3  # real intermediate ticks


def test_bucket_shapes_identical_outputs(rng):
    """bucket_shapes pads the compiled geometry only: outputs equal the
    unbucketed run bitwise (padded rows have empty windows + unusable
    flags; wider bands add only masked pairs)."""
    from nldsc_jax.config import LDConfig
    from nldsc_jax.ld.pipeline import _bucket_rows, compute_ld_scores

    from utils import make_positions, random_genotypes

    m, n = 330, 160                      # m_pad 352 -> bucket 384 (B=32)
    g = random_genotypes(rng, m, n, missing_rate=0.02)
    pos = make_positions(m, spacing=800, jitter_rng=rng)
    cfg = LDConfig(ld_wind=9000.0, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=32)
    plain = compute_ld_scores(g, pos, cfg)
    bucketed = compute_ld_scores(g, pos, cfg, bucket_shapes=True)
    for k in plain:
        np.testing.assert_array_equal(plain[k], bucketed[k], err_msg=k)

    annot = np.column_stack([np.ones(m), (rng.random(m) < 0.4).astype(float)])
    pa = compute_ld_scores(g, pos, cfg, annot=annot)
    pb = compute_ld_scores(g, pos, cfg, annot=annot, bucket_shapes=True)
    for k in ("l2_annot", "l2d_annot"):
        np.testing.assert_allclose(pa[k], pb[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=k)

    assert _bucket_rows(352, 32) in (384, 512)
    # idempotent at bucket sizes
    assert _bucket_rows(_bucket_rows(352, 32), 32) == _bucket_rows(352, 32)


def test_bucket_shapes_collapse_genome():
    """The compile-shape tuples of a 20-chromosome genome collapse to a
    handful under bucketing (the compile-per-size cost ld-genome pays is
    mechanical: one executable per distinct (m_pad, band_k, right_k))."""
    from nldsc_jax.ld.pipeline import _bucket_k, _bucket_rows

    B = 512
    sizes = [8192 + (c % 5) * 2048 for c in range(1, 21)]
    plain = {(-(-m // B) * B,) for m in sizes}
    bucketed = {(_bucket_rows(-(-m // B) * B, B),) for m in sizes}
    assert len(plain) == 5
    assert len(bucketed) <= 3
    # realistic chromosome sizes: 22 distinct -> few buckets
    real = [int(x) for x in np.linspace(15000, 120000, 22)]
    plain_r = {(-(-m // B) * B,) for m in real}
    buck_r = {(_bucket_rows(-(-m // B) * B, B),) for m in real}
    assert len(plain_r) == 22 and len(buck_r) <= 7
    assert _bucket_k(3) == 4 and _bucket_k(4) == 4 and _bucket_k(1) == 2
