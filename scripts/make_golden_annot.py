"""Generate the FROZEN partitioned-LD golden file (run once; the output
is committed and never regenerated automatically — tests/test_golden.py
explains the policy)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from nldsc_jax.ld.oracle import oracle_ld_annot
from utils import adversarial_genotypes, make_positions, random_genotypes

WIND, MAF, STD = 12000.0, 0.01, 1e-4

rng = np.random.default_rng(20260819)
adv = adversarial_genotypes(rng, 192)
g = np.concatenate([random_genotypes(rng, 120, 192, missing_rate=0.04),
                    adv,
                    random_genotypes(rng, 120, 192, missing_rate=0.0)])
m = len(g)
pos = make_positions(m, spacing=700, skip_idx=(5, 60), jitter_rng=rng)
annot = np.column_stack([
    np.ones(m),
    (rng.random(m) < 0.3).astype(np.float64),
    rng.uniform(0, 2, m),
])

ora = oracle_ld_annot(g, pos, WIND, MAF, STD, annot)
out = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                   "golden_annot_toy.npz")
np.savez_compressed(out, genotypes=g, positions=pos, annot=annot,
                    l2_annot=ora["l2_annot"], l2d_annot=ora["l2d_annot"])
print(f"wrote {out} (M={m}, p={annot.shape[1]})")
