"""Generate a synthetic PLINK bfile for benchmarks/repro.

Usage: python scripts/make_test_bfile.py PREFIX [M] [N] [missing_rate] [seed]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

from nldsc_jax.io.plink import write_plink
from utils import random_genotypes


def main():
    prefix = sys.argv[1] if len(sys.argv) > 1 else "toy"
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 1_000
    miss = float(sys.argv[4]) if len(sys.argv) > 4 else 0.0
    seed = int(sys.argv[5]) if len(sys.argv) > 5 else 0
    rng = np.random.default_rng(seed)
    g = random_genotypes(rng, m, n, missing_rate=miss)
    bp = np.arange(1, m + 1, dtype=np.int64) * 500
    write_plink(prefix, g, bp=bp)
    print(f"wrote {prefix}.bed/.bim/.fam  (M={m}, N={n}, missing={miss})")


if __name__ == "__main__":
    main()
