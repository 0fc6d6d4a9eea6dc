"""UKB-scale sample-count config on one chip (VERDICT r1 item 3).

M=4096 SNPs x N=300,032 samples (UKB-like N), window ±1000 SNPs, one
dispatch, data generated on device.  Three missingness regimes:
none / entry-uniform 2% (every row contaminated, global 8-matmul
engine) / 2% of rows contaminated (split-missing engine).
Usage: python scripts/time_ukb.py
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp

from nldsc_jax.ld import ld_int8, ld_split, windows

M, N, W, B = 4096, 300032, 1000, 256
SPACING = 100.0

pos = np.arange(1, M + 1, dtype=np.float64) * SPACING
lo, hi, pos_ok = windows.window_bounds(pos, W * SPACING)
blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, M // B)
right_k = windows.right_band_blocks(blk_hi, B)
meta = (jnp.asarray(pos_ok), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(blk_lo), jnp.asarray(blk_hi))

rowmiss_h = np.zeros(M, dtype=bool)
rowmiss_h[::50] = True
plan = ld_split.plan_split_v2(rowmiss_h, lo, hi,
                              min(ld_split.SEG_ROWS_DEFAULT, M), M)
rowmiss_dev = jnp.asarray(rowmiss_h)

for mode in ("clean", "entries", "rows"):
    @jax.jit
    def gen(key, mode=mode):
        g = jax.random.randint(key, (M, N), 0, 3, jnp.int8)
        if mode == "entries":
            mk = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.02,
                                      (M, N))
            g = jnp.where(mk, jnp.int8(-1), g)
        elif mode == "rows":
            mk = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.05,
                                      (M, N))
            mk = mk & jnp.asarray(rowmiss_h)[:, None]
            g = jnp.where(mk, jnp.int8(-1), g)
        return g

    @jax.jit
    def full_pass(g_dev, mode=mode):
        pre = ld_int8.preprocess_int8(g_dev, meta[0], jnp.float32(0.01),
                                      n_samples=N,
                                      assume_no_missing=mode == "clean",
                                      materialize_m=mode != "rows")
        dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
        args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
                meta[1], meta[2], pre["usable"], dom_ok, pre["add_sd_zero"])
        if mode == "rows":
            m_c = ld_split.compact_missing_rows(
                g_dev, jnp.asarray(plan["miss_idx"]))
            out = ld_split.ld_scores_split(
                args[0], m_c, *args[2:], rowmiss_dev, jnp.float32(1e-4),
                plan, block_size=B, right_k=right_k, n_samples=N,
                dot_dtype="int8")
        else:
            out = ld_int8.ld_scores_int8_sym(
                *args, meta[3], meta[4], jnp.float32(1e-4), block_size=B,
                band_k=band_k, right_k=right_k, n_samples=N,
                has_missing=mode == "entries", dot_dtype="int8")
        return out[0]

    gw, gt = gen(jax.random.PRNGKey(1)), gen(jax.random.PRNGKey(2))
    np.asarray(gw[:1, :1]); np.asarray(gt[:1, :1])
    np.asarray(full_pass(gw))
    t0 = time.time()
    l2 = np.asarray(full_pass(gt))
    dt = time.time() - t0
    assert np.isfinite(l2).sum() > M * 0.9
    n_dots = {"clean": 3, "entries": 8, "rows": 3}[mode]
    ops = n_dots * 2.0 * M * right_k * B * N
    print(f"UKB-N {mode:7s}: {dt*1e3:7.1f} ms  {M/dt:9,.0f} SNPs/s  "
          f"({ops/dt/1e12:5.1f} Tops/s {'matmul-' if mode == 'rows' else ''}"
          "actual)", flush=True)
