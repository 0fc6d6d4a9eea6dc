"""Micro-time preprocess_int8 and the sym kernel separately on the chip.

Usage: python scripts/time_preprocess.py [M] [N]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax.numpy as jnp

from nldsc_jax.ld import ld_int8, windows

M = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
N = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
W, B, SPACING = 1000, 256, 100.0


def make(seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(M, N), dtype=np.int8)
    return jnp.asarray(g)


pos = np.arange(1, M + 1, dtype=np.float64) * SPACING
lo, hi, pos_ok = windows.window_bounds(pos, W * SPACING)
blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, M // B)
right_k = windows.right_band_blocks(blk_hi, B)
pos_ok_d = jnp.asarray(pos_ok)

g_warm, g_time = make(1), make(2)
np.asarray(g_warm[:2])
np.asarray(g_time[:2])


def run_pre(g):
    pre = ld_int8.preprocess_int8(g, pos_ok_d, jnp.float32(0.01), n_samples=N)
    return np.asarray(pre["am"]), pre


_, pre_warm = run_pre(g_warm)
t0 = time.time()
_, pre_time = run_pre(g_time)
dt_pre = time.time() - t0
print(f"preprocess_int8: {dt_pre*1e3:7.1f} ms")


def run_kernel(pre):
    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
    out = ld_int8.ld_scores_int8_sym(
        pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
        jnp.asarray(lo), jnp.asarray(hi),
        pre["usable"], dom_ok, pre["add_sd_zero"], jnp.asarray(blk_lo),
        jnp.asarray(blk_hi), jnp.float32(1e-4), block_size=B, band_k=band_k,
        right_k=right_k, n_samples=N, has_missing=False, dot_dtype="bf16")
    return np.asarray(out[0])


run_kernel(pre_warm)
t0 = time.time()
run_kernel(pre_time)
dt_k = time.time() - t0
print(f"sym kernel:      {dt_k*1e3:7.1f} ms  ({M/dt_k:,.0f} SNPs/s kernel-only)")
print(f"combined rate:   {M/(dt_pre+dt_k):,.0f} SNPs/s")


# --- A/B: the old (f32-materializing) preprocess for comparison ---
import jax
from functools import partial


@partial(jax.jit, static_argnames=("n_samples",))
def preprocess_old(genotypes, pos_ok, maf_thr, n_samples):
    g = genotypes
    n = jnp.float32(n_samples)
    valid = g >= 0
    gq = jnp.where(valid, g, 0).astype(jnp.int8)
    mq = (~valid).astype(jnp.int8)
    hq = jnp.where(valid, 2 * jnp.minimum(g, 1), 0).astype(jnp.int8)
    gf = gq.astype(jnp.float32)
    n_valid_raw = jnp.sum(valid, axis=1)
    all_missing = n_valid_raw == 0
    n_valid = jnp.maximum(n_valid_raw, 1).astype(jnp.float32)
    add_sum = jnp.sum(gf, axis=1)
    dom_sum = jnp.sum(hq.astype(jnp.float32), axis=1)
    am = add_sum / n_valid
    dm = dom_sum / n_valid
    sgg = jnp.sum(gf * gf, axis=1)
    sgh = jnp.sum(gf * hq.astype(jnp.float32), axis=1)
    shh = jnp.sum(jnp.square(hq.astype(jnp.float32)), axis=1)
    return gq, mq, hq, am, dm, sgg, sgh, shh, all_missing


def run_old(g):
    outs = preprocess_old(g, pos_ok_d, jnp.float32(0.01), n_samples=N)
    return np.asarray(outs[3])


run_old(g_warm)
t0 = time.time()
run_old(g_time)
print(f"preprocess OLD:  {(time.time()-t0)*1e3:7.1f} ms")
