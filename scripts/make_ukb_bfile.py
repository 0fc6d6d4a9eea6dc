"""Generate a UKB-scale synthetic bfile on disk, streamed (never holds
the (M, N) matrix in RAM).

Default shape M=65,536 SNPs x N=300,032 samples (~4.9 GB .bed) with ~2%
of SNP rows carrying 5% missing genotypes — the production shape the
reference demonstrates (UKB, N=315,599: /root/reference/README.md) and
the one VERDICT r4 #3 requires the CLI to be driven at end-to-end.

Usage: python scripts/make_ukb_bfile.py PREFIX [M] [N] [seed]
"""
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from nldsc_jax.io.plink import PLINK_MAGIC, encode_bed_bytes

prefix = sys.argv[1]
M = int(sys.argv[2]) if len(sys.argv) > 2 else 65536
N = int(sys.argv[3]) if len(sys.argv) > 3 else 300032
seed = int(sys.argv[4]) if len(sys.argv) > 4 else 99
CHUNK = 2048
ROW_MISS_EVERY = 50          # 2% of rows contaminated
MISS_RATE = 0.05             # 5% of samples missing within those

rng = np.random.default_rng(seed)
t0 = time.time()
with open(prefix + ".bed", "wb") as f:
    f.write(PLINK_MAGIC)
    for s in range(0, M, CHUNK):
        e = min(s + CHUNK, M)
        # MAF-varied rows (so maf filters bite realistically): draw a
        # per-row allele frequency in [0.02, 0.5], binomial(2, p) codes
        p = rng.uniform(0.02, 0.5, size=(e - s, 1))
        g = rng.binomial(2, p, size=(e - s, N)).astype(np.int8)
        miss_rows = np.nonzero((np.arange(s, e) % ROW_MISS_EVERY) == 0)[0]
        for r in miss_rows:
            mask = rng.random(N) < MISS_RATE
            g[r, mask] = -1
        f.write(encode_bed_bytes(g).tobytes())
        if (s // CHUNK) % 8 == 0:
            print(f"  .bed rows {e}/{M} ({time.time() - t0:.0f}s)",
                  flush=True)

with open(prefix + ".bim", "w") as f:
    for i in range(M):
        bp = (i + 1) * 1000            # 1 kb spacing
        f.write(f"1\trs{i + 1}\t{bp * 1e-6:.6f}\t{bp}\tA\tG\n")
with open(prefix + ".fam", "w") as f:
    for i in range(N):
        f.write(f"F{i}\tI{i}\t0\t0\t0\t-9\n")
print(f"wrote {prefix}.bed/.bim/.fam  M={M} N={N}  "
      f"({time.time() - t0:.0f}s)")
