"""Same-process bucket-shapes measurement (r4).

This compares compile sharing within ONE process: six chromosomes of
three distinct sizes run through `estimate_lds` twice — first with
`bucket_shapes=True` (expected: 2 compiled shapes), then with the exact
per-size shapes (expected: 3 fresh compiles, no reuse of the bucketed
executables).  The per-chromosome wall decomposition shows which runs
compiled and which reused.

Usage: python scripts/time_bucket.py
"""

import sys
import tempfile
import time

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import numpy as np

from nldsc_jax.io.plink import write_plink
from nldsc_jax.ld.pipeline import estimate_lds

N = 4096
SIZES = [4096, 5120, 6144, 4096, 5120, 6144]   # 3 distinct shapes, twice

rng = np.random.default_rng(3)
with tempfile.TemporaryDirectory() as td:
    prefixes = []
    for i, m in enumerate(SIZES):
        g = rng.integers(0, 3, size=(m, N), dtype=np.int8)
        bp = np.arange(1, m + 1, dtype=np.int64) * 100
        prefixes.append(write_plink(f"{td}/c{i}", g, bp=bp))
    print(f"6 chromosomes (sizes {sorted(set(SIZES))}), N={N}", flush=True)

    for label, bucket in (("bucketed ", True), ("exact    ", False)):
        t_phase = time.time()
        per = []
        for i, prefix in enumerate(prefixes):
            t0 = time.time()
            estimate_lds(prefix, ld_wind=100.0, wind_metric="kbp",
                         maf_thr=0.01, std_thr=1e-4,
                         out=f"{td}/o{label.strip()}{i}.L2",
                         progress=False, bucket_shapes=bucket)
            per.append(time.time() - t0)
        total = time.time() - t_phase
        per_s = " ".join(f"{p:5.1f}" for p in per)
        print(f"[{label}] total {total:6.1f}s | per-chromosome: {per_s}",
              flush=True)
