"""Time the reference's OWN executed C++ LD kernel (BASELINE.md item 2).

The executed-parity harness (nldsc_jax/native/refshim, r4) makes the
reference binary runnable here for the first time: this measures its
wall-clock on synthetic bfiles at the BASELINE protocol scales — the
reference's `calculate()` compiled with its own flags (-O3 -march=native
-fopenmp) running all host cores — for a like-for-like anchor against
the device engine rates in bench.py.

Usage: python scripts/time_reference.py [M] [N] [WIN_SNPS]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import numpy as np

M = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
N = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000
W = int(sys.argv[3]) if len(sys.argv) > 3 else 1_000
SPACING = 100.0

from nldsc_jax.io.plink import write_plink
from nldsc_jax.native import refbinary

if not refbinary.available():
    raise SystemExit("reference tree not mounted / build failed")

rng = np.random.default_rng(0)
g = rng.integers(0, 3, size=(M, N), dtype=np.int8)
pos = np.arange(1, M + 1, dtype=np.float64) * SPACING

with tempfile.TemporaryDirectory() as td:
    prefix = os.path.join(td, "ref")
    write_plink(prefix, g, bp=pos.astype(np.int64))
    t0 = time.time()
    res = refbinary.calculate_reference(
        prefix + ".bed", M, N, W * SPACING, 0.01, 1e-4, 1e-3, pos)
    dt = time.time() - t0

finite = int(np.isfinite(res["l2"]).sum())
macs = 4.0 * M * (2 * W) * N
print(f"reference C++ (OpenMP x{os.cpu_count()} cores): M={M} N={N} "
      f"window +-{W} SNPs")
print(f"  wall {dt:8.2f} s  {M / dt:9,.0f} SNPs/s  "
      f"({macs / dt / 1e9:6.2f} GMAC/s)  [{finite}/{M} finite L2]",
      flush=True)
