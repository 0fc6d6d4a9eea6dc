"""Golden-file regression: frozen float64 oracle outputs on an adversarial
chr22-style toy dataset (tests/data/golden_chr22_toy.npz).

Guards both the oracle and every engine against silent semantic drift —
the expected values were generated once from the float64 oracle and are
never regenerated automatically.
"""

import os

import numpy as np
import pytest

from nldsc_jax.config import LDConfig
from nldsc_jax.ld.oracle import oracle_ld
from nldsc_jax.ld.pipeline import compute_ld_scores
from nldsc_jax.parallel import ld_scores_sharded, snp_mesh

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_chr22_toy.npz")
WIND, MAF, STD, RSQ = 12000.0, 0.01, 1e-4, 1e-3


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


def check(res, golden, rtol=2e-5, atol=2e-4):
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(res[k], golden[k], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=k)
    np.testing.assert_allclose(res["maf"], golden["maf"], atol=1e-6,
                               equal_nan=True)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(res[k], golden[k], err_msg=k)


def test_oracle_reproduces_golden(golden):
    ora = oracle_ld(golden["genotypes"], golden["positions"],
                    WIND, MAF, STD, RSQ)
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_allclose(ora[k], golden[k], rtol=1e-12,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize(
    "engine", ["int8", "int8-sym", "f32-sym", "f32-plain"])
def test_engines_match_golden(golden, engine):
    cfg = LDConfig(ld_wind=WIND, wind_metric="bp", maf_thr=MAF, std_thr=STD,
                   rsq_thr=RSQ, block_size=32,
                   use_int8=engine.startswith("int8"),
                   symmetric=engine.endswith("sym"))
    res = compute_ld_scores(golden["genotypes"], golden["positions"], cfg)
    check(res, golden)


def test_sharded_matches_golden(golden):
    cfg = LDConfig(ld_wind=WIND, wind_metric="bp", maf_thr=MAF, std_thr=STD,
                   rsq_thr=RSQ, block_size=8)
    res = ld_scores_sharded(golden["genotypes"], golden["positions"], cfg,
                            snp_mesh(4))
    check(res, golden)


GOLDEN_ANNOT = os.path.join(os.path.dirname(__file__), "data",
                            "golden_annot_toy.npz")
ANNOT_WIND, ANNOT_STD = 12000.0, 1e-4


@pytest.mark.parametrize("engine", ["int8", "f32", "streaming"])
def test_annot_engines_match_golden(engine, tmp_path):
    """Frozen partitioned-LD outputs across every annot-capable route."""
    from nldsc_jax.ld.pipeline import compute_ld_scores_annot

    gold = dict(np.load(GOLDEN_ANNOT))
    g, pos, annot = gold["genotypes"], gold["positions"], gold["annot"]
    cfg = LDConfig(ld_wind=ANNOT_WIND, wind_metric="bp", maf_thr=MAF,
                   std_thr=ANNOT_STD, rsq_thr=RSQ, block_size=32,
                   use_int8=engine != "f32")
    if engine == "streaming":
        from nldsc_jax.io.plink import BedReader, write_plink
        from nldsc_jax.ld.streaming import compute_ld_scores_streaming

        prefix = write_plink(tmp_path / "ga", g, bp=pos.astype(np.int64))
        # write_plink stores positions; skip-sentinel rows (-1) are not
        # representable in a .bim, so pass the oracle positions directly
        bed = BedReader(prefix + ".bed", *g.shape)
        res = compute_ld_scores_streaming(bed, pos, cfg, chunk_rows=64,
                                          annot=annot)
    else:
        res = compute_ld_scores_annot(g, pos, annot, cfg)
    np.testing.assert_allclose(res["l2_annot"], gold["l2_annot"],
                               rtol=2e-5, atol=2e-4, equal_nan=True)
    np.testing.assert_allclose(res["l2d_annot"], gold["l2d_annot"],
                               rtol=2e-5, atol=2e-4, equal_nan=True)
