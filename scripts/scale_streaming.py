"""Hardware validation of the out-of-core streaming engine at chr scale.

Generates a chr1-like bfile on disk (default M=50k SNPs x N=20k samples,
~250 MB .bed), then runs the streaming LD pass end-to-end (decode ->
device -> banded matmuls -> outputs) and reports wall-clock + throughput.

Usage: python scripts/scale_streaming.py [M] [N] [win_snps] [chunk_rows]
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from nldsc_jax.config import LDConfig
from nldsc_jax.io.plink import BedReader, encode_bed_bytes, PLINK_MAGIC
from nldsc_jax.ld.streaming import compute_ld_scores_streaming


def write_big_bed(path, m, n, seed=0, row_chunk=4096):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        f.write(PLINK_MAGIC)
        for s in range(0, m, row_chunk):
            e = min(s + row_chunk, m)
            g = rng.integers(0, 3, size=(e - s, n), dtype=np.int8)
            f.write(encode_bed_bytes(g).tobytes())


def main():
    argv = [int(a) for a in sys.argv[1:]]
    m = argv[0] if argv else 50_000
    n = argv[1] if len(argv) > 1 else 20_000
    w = argv[2] if len(argv) > 2 else 1000
    chunk = argv[3] if len(argv) > 3 else 8192

    with tempfile.TemporaryDirectory() as d:
        bed_path = os.path.join(d, "big.bed")
        t0 = time.time()
        write_big_bed(bed_path, m, n)
        print(f"wrote {os.path.getsize(bed_path) / 1e6:.0f} MB .bed "
              f"in {time.time() - t0:.1f}s")

        bed = BedReader(bed_path, m, n)
        pos = np.arange(1, m + 1, dtype=np.float64) * 100.0
        cfg = LDConfig(ld_wind=min(w * 100.0, 5e6), wind_metric="bp",
                       maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-4,
                       block_size=256)
        t0 = time.time()
        res = compute_ld_scores_streaming(bed, pos, cfg, chunk_rows=chunk)
        dt = time.time() - t0
        ok = np.isfinite(res["l2"]).sum()
        print(f"streaming: M={m} N={n} W=±{w}: {dt:.1f}s "
              f"({m / dt:,.0f} SNPs/s end-to-end incl. IO), "
              f"{ok}/{m} non-null L2, mean L2 {np.nanmean(res['l2']):.2f}")


if __name__ == "__main__":
    main()
