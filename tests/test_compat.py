"""Reference low-level API compatibility (compat.LDScoreParams/calculate)."""

import numpy as np

from nldsc_jax.compat import LDScoreParams, LDScoreResult, calculate
from nldsc_jax.io.plink import write_plink
from nldsc_jax.ld.oracle import oracle_ld

from utils import make_positions, random_genotypes


def test_calculate_matches_oracle(tmp_path, rng):
    m, n = 120, 150
    g = random_genotypes(rng, m, n, missing_rate=0.03)
    bp = make_positions(m, spacing=600)
    prefix = write_plink(tmp_path / "compat", g, bp=bp.astype(np.int64))

    params = LDScoreParams(
        bfile=prefix + ".bed", n_snp=m, n_org=n, ld_wind=5000.0,
        maf=0.01, std_thr=1e-4, rsq_thr=1e-3,
        positions=list(bp),
    )
    res = calculate(params, block_size=16)
    assert isinstance(res, LDScoreResult)
    assert len(res.l2) == m and len(res.l2d_wse) == m

    ora = oracle_ld(g, bp, 5000.0, 0.01, 1e-4, 1e-3)
    np.testing.assert_allclose(np.array(res.l2), ora["l2"], rtol=2e-5,
                               atol=2e-4, equal_nan=True)
    np.testing.assert_array_equal(np.array(res.l2_ws), ora["l2_ws"])


def test_positions_sentinel_via_compat(tmp_path, rng):
    m, n = 48, 60
    g = random_genotypes(rng, m, n)
    bp = make_positions(m, spacing=1000)
    prefix = write_plink(tmp_path / "sent", g, bp=bp.astype(np.int64))
    pos = list(bp)
    pos[5] = -1.0  # reference sentinel
    params = LDScoreParams(bfile=prefix + ".bed", n_snp=m, n_org=n,
                           ld_wind=3000.0, maf=0.01, std_thr=1e-4,
                           rsq_thr=1e-3, positions=pos)
    res = calculate(params, block_size=16)
    assert np.isnan(res.l2[5]) and np.isnan(res.maf[5])
    assert res.l2_ws[5] == -1


def test_calculate_routes_big_inputs_to_streaming(tmp_path, rng, monkeypatch):
    # shrink the threshold so this toy input takes the out-of-core path,
    # and check results are unchanged
    import nldsc_jax.ld.pipeline as ld_pipeline

    m, n = 96, 70
    g = random_genotypes(rng, m, n, missing_rate=0.02)
    bp = make_positions(m, spacing=700)
    prefix = write_plink(tmp_path / "big", g, bp=bp.astype(np.int64))
    params = LDScoreParams(bfile=prefix + ".bed", n_snp=m, n_org=n,
                           ld_wind=4000.0, maf=0.01, std_thr=1e-4,
                           rsq_thr=1e-3, positions=list(bp))
    dense = calculate(params, block_size=16)

    called = {}
    import nldsc_jax.ld.streaming as streaming_mod
    orig = streaming_mod.compute_ld_scores_streaming

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(streaming_mod, "compute_ld_scores_streaming", spy)
    monkeypatch.setattr(ld_pipeline, "streaming_bytes_limit", lambda: 1)
    streamed = calculate(params, block_size=16)
    assert called.get("yes")
    np.testing.assert_allclose(np.array(streamed.l2), np.array(dense.l2),
                               rtol=3e-6, atol=3e-6, equal_nan=True)
    np.testing.assert_array_equal(streamed.l2d_ws, dense.l2d_ws)
