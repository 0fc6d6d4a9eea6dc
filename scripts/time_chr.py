"""Chromosome-scale END-TO-END bfile→.L2 measurement (VERDICT r2 item 3).

Builds a real on-disk bfile at M=131,072 SNPs × N=16,384 samples
(.bed = 537 MB — UKB-chromosome order of magnitude in SNP count), then
measures the ACTUAL user path `estimate_lds(bfile, out=...)` twice
(run 1 includes jit compile; run 2 is the honest steady-state number),
for both the auto-selected engine path and forced streaming, plus a
decomposition of where the time goes (disk read / host→device transfer
/ everything else).

The decomposition separates disk read and host→device transfer from
the device pass.

Usage: python scripts/time_chr.py [M] [N]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np

M = int(sys.argv[1]) if len(sys.argv) > 1 else 131072
N = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
WIN_KB = 100.0           # ±1000 SNPs at 100 bp spacing

from nldsc_jax.io.plink import PlinkDataset, write_plink
from nldsc_jax.ld.pipeline import estimate_lds


def make_bfile(prefix, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(M, N), dtype=np.int8)
    bp = np.arange(1, M + 1, dtype=np.int64) * 100
    t0 = time.time()
    write_plink(prefix, g, bp=bp)
    print(f"  bfile written: {os.path.getsize(prefix + '.bed') / 1e6:.0f} MB "
          f"({time.time() - t0:.1f}s)", flush=True)


def run(prefix, out, **kw):
    t0 = time.time()
    estimate_lds(prefix, ld_wind=WIN_KB, wind_metric="kbp", maf_thr=0.01,
                 std_thr=1e-4, out=out, progress=False, **kw)
    return time.time() - t0


with tempfile.TemporaryDirectory() as td:
    warm, bench = f"{td}/warm", f"{td}/chr1"
    print(f"M={M} N={N} (.bed {M * ((N + 3) // 4) / 1e6:.0f} MB)", flush=True)
    make_bfile(warm, 1)
    make_bfile(bench, 2)

    # --- decomposition (disk + transfer), measured on the bench file ---
    ds = PlinkDataset.parse(bench)
    t0 = time.time()
    packed = ds.bed.read_raw()
    t_disk = time.time() - t0
    import jax
    t0 = time.time()
    jax.device_put(packed.raw).block_until_ready()
    t_xfer = time.time() - t0
    mb = packed.raw.nbytes / 1e6
    print(f"  decomposition: disk read {t_disk:.1f}s ({mb / t_disk:.0f} "
          f"MB/s) | host->device {t_xfer:.1f}s ({mb / t_xfer:.1f} MB/s)",
          flush=True)

    for label, kw in (("auto", {}), ("streaming", dict(streaming=True,
                                                       chunk_rows=16384))):
        dt_cold = run(warm, f"{td}/w.L2", **kw)
        dt = run(bench, f"{td}/b.L2", **kw)
        n_rows = sum(1 for _ in open(f"{td}/b.L2")) - 1
        assert n_rows == M
        print(f"e2e [{label:9s}]: cold {dt_cold:7.1f}s | warm {dt:7.1f}s "
              f"({M / dt:,.0f} SNPs/s e2e)", flush=True)
