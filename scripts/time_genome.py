"""Whole-genome demonstration run (VERDICT r3 item 5).

Generates ~20 synthetic single-chromosome bfiles (mixed sizes, a few with
row-structured missing genotypes), drives the REAL CLI surface:

  1. `ld-genome` over the whole set -> per-chromosome .L2/.M/.M_5_50
  2. `ld --annot` on one chromosome  -> partitioned .L2 (separate dir)
  3. `h2` on the produced DIRECTORY: two-stg, one-stg, --on-device
  4. `h2 --partitioned` on the partitioned chromosome

and prints a per-stage wall-clock decomposition.  This is the product
loop at genome scale — it catches cross-run compile caching, memory
growth, .M-directory aggregation and CLI plumbing that per-chromosome
micro-benchmarks cannot.  Matches the reference's intended usage
(nldsc README: per-chromosome ld runs, then h2 over the scores).

Usage: python scripts/time_genome.py [N_CHROM] [N_SAMPLES] [M_BASE]
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, ".")

import numpy as np
import pandas as pd

N_CHROM = int(sys.argv[1]) if len(sys.argv) > 1 else 20
N = int(sys.argv[2]) if len(sys.argv) > 2 else 8192
M_BASE = int(sys.argv[3]) if len(sys.argv) > 3 else 8192

from nldsc_jax.io.plink import write_plink


def cli(*args, timeout=3600):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.abspath(".") + ":"
                         + env.get("PYTHONPATH", ""))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "nldsc_jax.cli", *args],
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    dt = time.time() - t0
    if r.returncode != 0 or "[C]" in r.stderr:
        print(r.stdout[-2000:])
        print(r.stderr[-2000:])
        raise SystemExit(f"CLI failed: {args[0]}")
    return dt


def make_genome(td, rng):
    total_m = 0
    prefixes = []
    snp_rows = []
    t0 = time.time()
    for c in range(1, N_CHROM + 1):
        m = M_BASE + (c % 5) * (M_BASE // 4)        # mixed sizes
        g = rng.integers(0, 3, size=(m, N), dtype=np.int8)
        if c in (3, 7, 12):                          # row-missing chroms
            rows = rng.choice(m, size=max(2, m // 40), replace=False)
            for i in rows:
                mask = rng.random(N) < 0.1
                g[i] = np.where(mask, np.int8(-1), g[i])
        bp = np.arange(1, m + 1, dtype=np.int64) * 100
        names = [f"c{c}_rs{i}" for i in range(m)]
        bim = pd.DataFrame({
            "CHR": np.full(m, c), "SNP": names,
            "CM": bp * 1e-6, "BP": bp, "A1": "A", "A2": "G"})
        prefix = f"{td}/chr{c:02d}"
        write_plink(prefix, g, bim=bim)
        prefixes.append(prefix)
        snp_rows.append(pd.DataFrame({
            "SNP": names, "Z": rng.normal(size=m), "N": 50000.0}))
        total_m += m
    dt = time.time() - t0
    print(f"  generated {N_CHROM} chromosomes, M_total={total_m:,} "
          f"N={N} ({dt:.1f}s, "
          f"{sum(os.path.getsize(p + '.bed') for p in prefixes) / 1e6:.0f}"
          " MB .bed)", flush=True)
    ss = pd.concat(snp_rows)
    ss_path = f"{td}/trait.sumstats"
    ss.to_csv(ss_path, sep="\t", index=False)
    return prefixes, ss_path, total_m


with tempfile.TemporaryDirectory() as td:
    rng = np.random.default_rng(2026)
    prefixes, ss_path, total_m = make_genome(td, rng)
    out_dir = f"{td}/scores"

    dt_ld = cli("ld-genome", "--bfiles", f"{td}/chr*.bed",
                "--out-dir", out_dir, "-kb", "100", "-maf", "0.01",
                "--extra")
    print(f"e2e [ld-genome  ]: {dt_ld:7.1f}s  "
          f"({total_m / dt_ld:,.0f} SNPs/s incl. one-time compiles)",
          flush=True)

    # partitioned run on one chromosome (separate dir: partitioned .L2
    # columns must not mix with plain ones in the h2 directory reader)
    m1 = sum(1 for _ in open(prefixes[0] + ".bim"))
    annot_df = pd.DataFrame({
        "SNP": [f"c1_rs{i}" for i in range(m1)],
        "base": 1.0,
        "cat": (np.random.default_rng(7).random(m1) < 0.3).astype(float)})
    annot_path = f"{td}/chr01.annot"
    annot_df.to_csv(annot_path, sep="\t", index=False)
    part_dir = f"{td}/part"
    os.makedirs(part_dir)
    dt_an = cli("ld", "--bfile", prefixes[0], "-kb", "100", "-maf", "0.01",
                "--annot", annot_path, "-o", f"{part_dir}/chr01.L2")
    print(f"e2e [ld --annot ]: {dt_an:7.1f}s  (chr01, 2 annotations)",
          flush=True)

    # r5 (VERDICT r4 #5): partitioned LD across the WHOLE genome into a
    # directory (bucketed shapes), then h2 --partitioned over it — the
    # genome-scale partitioned product loop, not just one chromosome
    rng2 = np.random.default_rng(77)
    annot_rows = []
    for c, p in enumerate(prefixes, 1):
        mc = sum(1 for _ in open(p + ".bim"))
        annot_rows.append(pd.DataFrame({
            "SNP": [f"c{c}_rs{i}" for i in range(mc)],
            "base": 1.0,
            "cat": (rng2.random(mc) < 0.3).astype(float)}))
    annot_all_path = f"{td}/genome.annot"
    pd.concat(annot_rows).to_csv(annot_all_path, sep="\t", index=False)
    part_all = f"{td}/part_all"
    dt_pg = cli("ld-genome", "--bfiles", f"{td}/chr*.bed",
                "--out-dir", part_all, "-kb", "100", "-maf", "0.01",
                "--annot", annot_all_path)
    print(f"e2e [ld-genome --annot]: {dt_pg:7.1f}s  "
          f"({N_CHROM} chromosomes, 2 annotations)", flush=True)
    dt_hp = cli("h2", "--sumstats", ss_path, "--ref-ld", part_all,
                "--w-ld", part_all, "--partitioned")
    print(f"e2e [h2 partition-genome]: {dt_hp:7.1f}s  (directory of "
          f"{N_CHROM} partitioned chromosomes)", flush=True)

    for label, extra in (("two-stg", []),
                         ("one-stg", ["--strategy", "one-stg"]),
                         ("on-device", ["--on-device"])):
        dt = cli("h2", "--sumstats", ss_path, "--ref-ld", out_dir,
                 "--w-ld", out_dir, *extra)
        print(f"e2e [h2 {label:9s}]: {dt:7.1f}s  (directory of "
              f"{N_CHROM} chromosomes, M={total_m:,})", flush=True)

    dt = cli("h2", "--sumstats", ss_path, "--ref-ld", f"{part_dir}/chr01.L2",
             "--w-ld", f"{part_dir}/chr01.L2", "--partitioned")
    print(f"e2e [h2 partition]: {dt:7.1f}s  (chr01 partitioned)", flush=True)
    print("genome loop complete", flush=True)
