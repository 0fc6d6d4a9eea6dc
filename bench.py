"""Benchmark: windowed LD-score pass throughput (SNPs/s per GPU).

Prints ONE JSON line to stdout:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}, ...}

* value: SNPs/s for the full additive+dominance windowed LD pass (fused
  on-device preprocess + symmetric integer-exact banded engine), N=16384
  samples, window +-1000 SNPs, over a batch of EIGHT 16384-SNP chromosome
  segments (position-separated, so windows never cross segments) in ONE
  dispatch — one engine dispatch per chromosome, as in an ``estimate_lds``
  run.  Secondary keys report the 2%-missing rates (8-matmul engine and
  split-missing engine) and the end-to-end bfile->.L2 wall-clock (disk
  decode + host transfer + compute + TSV write) with its stage split.
* vs_baseline: ratio against a single-node CPU baseline implementing the
  same blocked-BLAS algorithm in NumPy f32 (multithreaded OpenBLAS) — a
  stand-in for the reference's C++/Armadillo per-pair engine (the
  reference publishes no numbers).

Benchmark genotypes are generated on the device, outside the timed
region; each timed pass is the median of five warm runs, each ending in a
device-to-host fetch.  The script exits non-zero unless JAX's default
backend is a GPU.
"""

import json
import sys
import time

import numpy as np

M, N, WIN_SNPS = 16384, 16384, 1000
SEGMENTS = 8                   # one-dispatch batch: 8 x M rows
SPACING = 100.0
BLOCK = 512   # the LDConfig default (scripts/time_block.py sweeps it)
MAF_THR, STD_THR, RSQ_THR = 0.01, 1e-4, 1e-3

CPU_M = 2048  # CPU baseline runs a subset, rate extrapolates per-SNP


def make_inputs(m, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(m, n), dtype=np.int8)
    pos = np.arange(1, m + 1, dtype=np.float64) * SPACING
    return g, pos


def segment_positions(m_total: int) -> np.ndarray:
    """Positions for SEGMENTS independent chromosome segments: contiguous
    within a segment, 1e9 bp apart between segments (no cross-segment
    windows)."""
    seg = np.arange(1, M + 1, dtype=np.float64) * SPACING
    return np.concatenate(
        [seg + i * 1e9 for i in range(m_total // M)])


def device_pass(has_missing=False, row_missing=False):
    """One-dispatch device LD pass over SEGMENTS×M SNPs; returns
    (seconds, m_total).

    On-device synthetic genotype generation is outside the timed region;
    fused preprocess + the symmetric integer-exact engine (int8 matmuls,
    exact int32 accumulation, analytic centering) + a fetch of the
    reduced l2 are inside — one jit call, like a per-chromosome run.

    ``has_missing``: entry-uniform 2% missing (EVERY row contaminated —
    the worst case; global 8-matmul epilogue).  ``row_missing``:
    realistic missingness concentrated in 2% of SNP rows (5% of samples
    missing within those) — routed through the split-missing engine
    (clean 3-matmul pass + compact exact corrections, ld_split.py).
    """
    import jax
    import jax.numpy as jnp

    from nldsc_jax.ld import ld_int8, ld_split, windows

    m_total = SEGMENTS * M
    pos = segment_positions(m_total)
    lo, hi, pos_ok = windows.window_bounds(pos, WIN_SNPS * SPACING)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, BLOCK,
                                                 m_total // BLOCK)
    right_k = windows.right_band_blocks(blk_hi, BLOCK)
    meta = (jnp.asarray(pos_ok), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(blk_lo), jnp.asarray(blk_hi))

    any_missing = has_missing or row_missing
    if row_missing:
        rowmiss_h = np.zeros(m_total, dtype=bool)
        rowmiss_h[::50] = True                      # 2% of rows
        plan = ld_split.plan_split_v2(
            rowmiss_h, lo, hi, min(ld_split.SEG_ROWS_DEFAULT, m_total),
            m_total)
        rowmiss_dev = jnp.asarray(rowmiss_h)

    @jax.jit
    def gen(key):
        g = jax.random.randint(key, (m_total, N), 0, 3, jnp.int8)
        if row_missing:
            miss = jax.random.bernoulli(jax.random.fold_in(key, 1),
                                        0.05, (m_total, N))
            miss = miss & jnp.asarray(rowmiss_h)[:, None]
            g = jnp.where(miss, jnp.int8(-1), g)
        elif has_missing:
            miss = jax.random.bernoulli(jax.random.fold_in(key, 1),
                                        0.02, (m_total, N))
            g = jnp.where(miss, jnp.int8(-1), g)
        return g

    @jax.jit
    def full_pass(g_dev):
        pre = ld_int8.preprocess_int8(g_dev, meta[0], jnp.float32(MAF_THR),
                                      n_samples=N,
                                      assume_no_missing=not any_missing,
                                      materialize_m=not row_missing)
        dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(STD_THR))
        args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
                meta[1], meta[2], pre["usable"], dom_ok, pre["add_sd_zero"])
        if row_missing:
            # v2 split: clean scan over all pairs + segmented δ-corrections
            # (the indicator matrix exists only as the COMPACT rows)
            m_c = ld_split.compact_missing_rows(
                g_dev, jnp.asarray(plan["miss_idx"]))
            out = ld_split.ld_scores_split(
                args[0], m_c, *args[2:], rowmiss_dev,
                jnp.float32(RSQ_THR), plan,
                block_size=BLOCK, right_k=right_k, n_samples=N,
                dot_dtype="int8")
        else:
            out = ld_int8.ld_scores_int8_sym(
                *args, meta[3], meta[4],
                jnp.float32(RSQ_THR), block_size=BLOCK, band_k=band_k,
                right_k=right_k, n_samples=N, has_missing=has_missing,
                dot_dtype="int8")
        # sanity reduction: finite-l2 sum and count
        l2 = out[0]
        fin = jnp.isfinite(l2)
        return jnp.stack([jnp.sum(jnp.where(fin, l2, 0.0)),
                          jnp.sum(fin).astype(jnp.float32)])

    g_dev = gen(jax.random.PRNGKey(0))
    v = np.asarray(full_pass(g_dev))          # compile + warm
    assert v[1] > m_total * 0.9 and np.isfinite(v[0])
    dts = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.asarray(full_pass(g_dev))          # dispatch + scalar fetch
        dts.append(time.perf_counter() - t0)
    return float(np.median(dts)), m_total


def e2e_bfile_to_l2(g_warm, g, pos):
    """End-to-end wall-clock: .bed on disk -> .L2 written (chr scale).

    Covers the whole user path: packed .bed read, host->device transfer,
    on-device unpack + preprocess + banded pass, result fetch, TSV + .M
    sidecar writes.  A warm-up run on another dataset of the same shape
    excludes one-time jit compilation, which in production amortizes
    across chromosomes.
    """
    import tempfile

    from nldsc_jax.io.plink import write_plink
    from nldsc_jax.ld.pipeline import estimate_lds

    kw = dict(ld_wind=WIN_SNPS * SPACING / 1000.0, wind_metric="kbp",
              maf_thr=MAF_THR, std_thr=STD_THR, block_size=BLOCK,
              progress=False)
    with tempfile.TemporaryDirectory() as td:
        pw = write_plink(f"{td}/warm", g_warm, bp=pos.astype(np.int64))
        estimate_lds(pw, out=f"{td}/warm.L2", **kw)          # compile
        prefix = write_plink(f"{td}/bench", g, bp=pos.astype(np.int64))
        out = f"{td}/bench.L2"
        t0 = time.time()
        estimate_lds(prefix, out=out, **kw)
        dt = time.time() - t0
        n_rows = sum(1 for _ in open(out)) - 1
        assert n_rows == g.shape[0]
    from nldsc_jax.ld import pipeline
    stages = {k: round(v, 3) for k, v in pipeline.STAGE_TIMES.items()}
    stages["other_s"] = round(dt - sum(stages.values()), 3)
    return dt, stages


def cpu_baseline(g, pos):
    """Same blocked algorithm in NumPy f32 on CPU (BLAS sgemm)."""
    m, n = g.shape
    gf = g.astype(np.float32)
    a = gf - gf.mean(axis=1, keepdims=True)
    sd = np.sqrt((a * a).mean(axis=1, keepdims=True))
    xa = a / sd
    d = np.minimum(gf, 1.0) * 2.0
    dc = d - d.mean(axis=1, keepdims=True)
    slope = (a * dc).sum(axis=1, keepdims=True) / (a * a).sum(axis=1, keepdims=True)
    r = dc - slope * a
    rs = np.sqrt((r * r).mean(axis=1, keepdims=True))
    xr = r / np.where(rs > 0, rs, 1.0)

    w = int(WIN_SNPS)
    adj = (n - 1.0) / (n - 2.0)
    t0 = time.time()
    l2 = np.empty(m)
    l2d = np.empty(m)
    for s in range(0, m, BLOCK):
        e = min(s + BLOCK, m)
        j0, j1 = max(0, s - w), min(m, e + w)
        c = xa[s:e] @ xa[j0:j1].T / n
        cd = xa[s:e] @ xr[j0:j1].T / n
        aa = 1.0 - (1.0 - c * c) * adj
        ad = 1.0 - (1.0 - cd * cd) * adj
        gi = np.arange(s, e)[:, None]
        gj = np.arange(j0, j1)[None, :]
        mask = (np.abs(gj - gi) <= w) & (gj != gi)
        l2[s:e] = 1.0 + (aa * mask).sum(axis=1)
        l2d[s:e] = (ad * mask).sum(axis=1)
    return time.time() - t0


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX's default backend is "
                 f"{jax.default_backend()!r}")
    dev = jax.devices()[0]

    # --- CPU baseline (subset, extrapolated per-SNP rate; min over 3
    # reps against host scheduling noise) ---
    g_cpu, pos_cpu = make_inputs(CPU_M, N, seed=11)
    cpu_dt = min(cpu_baseline(g_cpu, pos_cpu) for _ in range(3))
    cpu_rate = CPU_M / cpu_dt

    # --- device pass, clean data (the headline number) ---
    dt, m_total = device_pass()
    rate = m_total / dt

    # --- device pass, entry-uniform 2% missing (worst case: every row
    # contaminated, global 8-matmul engine path) ---
    dt_miss, _ = device_pass(has_missing=True)
    rate_miss = m_total / dt_miss

    # --- device pass, missing concentrated in 2% of rows (realistic;
    # split-missing engine: clean-rate pass + compact corrections) ---
    dt_rowmiss, _ = device_pass(row_missing=True)
    rate_rowmiss = m_total / dt_rowmiss

    # --- end-to-end bfile -> .L2 (decode + transfer + compute + write) ---
    g_e2e, pos_e2e = make_inputs(M, N, seed=40)
    g_e2e_warm, _ = make_inputs(M, N, seed=41)
    rng = np.random.default_rng(31)
    g_e2e[rng.random(g_e2e.shape) < 0.02] = -1
    g_e2e_warm[rng.random(g_e2e_warm.shape) < 0.02] = -1
    e2e_dt, e2e_stages = e2e_bfile_to_l2(g_e2e_warm, g_e2e, pos_e2e)

    print(json.dumps({
        "metric": "ld_snps_per_sec_per_gpu",
        "value": round(rate, 1),
        "unit": (f"SNPs/s/GPU (M={m_total} = {SEGMENTS}x{M} segments, "
                 f"N={N}, window ±{WIN_SNPS} SNPs, add+dom, one dispatch)"),
        "vs_baseline": round(rate / cpu_rate, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "missing2pct_snps_per_sec": round(rate_miss, 1),
        "missing2pct_rows_snps_per_sec": round(rate_rowmiss, 1),
        "e2e_bfile_to_l2_seconds": round(e2e_dt, 2),
        "e2e_snps_per_sec": round(M / e2e_dt, 1),
        "e2e_decomposition": e2e_stages,
    }))
    print(f"# {dev.device_kind}: {dt:.3f}s ({rate:,.0f} SNPs/s) | 2% "
          f"entries missing: {rate_miss:,.0f} | 2% rows missing (split): "
          f"{rate_rowmiss:,.0f} SNPs/s | e2e bfile->L2 (M={M}): "
          f"{e2e_dt:.1f}s {e2e_stages} | cpu-baseline: {cpu_rate:,.0f} "
          f"SNPs/s (NumPy/BLAS subset M={CPU_M}, add+dom)", file=sys.stderr)


if __name__ == "__main__":
    main()
