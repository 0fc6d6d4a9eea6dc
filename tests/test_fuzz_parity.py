"""Randomized cross-engine fuzz: random configs/data vs the float64 oracle.

Each case draws sizes, window, thresholds, missing rate, sentinels, and an
engine, then asserts full parity.  Seeded (deterministic) but broad —
regression armor for the mask/correction algebra across all engines.
"""

import numpy as np
import pytest

from nldsc_jax.config import LDConfig
from nldsc_jax.ld.oracle import oracle_ld
from nldsc_jax.ld.pipeline import compute_ld_scores

from test_ld_device import assert_ld_parity
from utils import make_positions, random_genotypes

ENGINES = ["int8", "int8-sym", "f32-sym", "f32-plain"]


@pytest.mark.parametrize("case", range(10))
def test_fuzz_engine_vs_oracle(case):
    rng = np.random.default_rng(7_000 + case)
    m = int(rng.integers(40, 220))
    n = int(rng.integers(64, 400))
    missing = float(rng.choice([0.0, 0.01, 0.15]))
    g = random_genotypes(rng, m, n, missing_rate=missing,
                         maf_low=0.005, maf_high=0.5)
    spacing = int(rng.integers(100, 2000))
    skip = tuple(rng.choice(m, size=rng.integers(0, 3), replace=False))
    pos = make_positions(m, spacing=spacing, jitter_rng=rng, skip_idx=skip)
    wind = float(rng.integers(2, 40)) * spacing
    maf_thr = float(rng.choice([1e-5, 0.01, 0.05]))
    std_thr = float(rng.choice([1e-5, 1e-3]))
    block = int(rng.choice([8, 16, 48]))
    engine = ENGINES[case % len(ENGINES)]

    cfg = LDConfig(ld_wind=wind, wind_metric="bp", maf_thr=maf_thr,
                   std_thr=std_thr, rsq_thr=1e-3, block_size=block,
                   use_int8=engine.startswith("int8"),
                   symmetric=engine.endswith("sym"))
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, wind, maf_thr, std_thr, 1e-3)
    assert_ld_parity(res, ora)
