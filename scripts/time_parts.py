"""Bisect the symmetric-engine pass: where do the non-roofline ms go?

Times, at the bench config (M=N=16384, W=1000, B=512), chained variants:
  dots     — the 3 half-band int8 matmuls per pivot block, scan, no epilogue
  epi      — dots + the full corr/adjust/mask epilogue, row sums only
  full     — the shipped ld_scores_int8_sym (epilogue + credit scatter)

Each variant runs Q passes dependency-chained in ONE dispatch (output of
pass p perturbs the scalars of pass p+1 so nothing is elided), one fetch.
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from nldsc_jax.ld import ld_int8, windows

M = N = 16384
W = 1000
B = 512
Q = 4
SPACING = 100.0

pos = np.arange(1, M + 1, dtype=np.float64) * SPACING
lo_h, hi_h, pos_ok = windows.window_bounds(pos, W * SPACING)
blk_lo, blk_hi, band_k = windows.band_blocks(lo_h, hi_h, B, M // B)
right_k = windows.right_band_blocks(blk_hi, B)
right_rows = right_k * B
nb = M // B

g_host = np.random.default_rng(5).integers(0, 3, (M, N), np.int8)
g = jnp.asarray(g_host)
np.asarray(g[:1, :1])

pre = ld_int8.preprocess_int8(g, jnp.asarray(pos_ok), jnp.float32(0.01),
                              n_samples=N, assume_no_missing=True)
dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
scal = ld_int8.stack_scalars(pre)
lo = jnp.asarray(lo_h)
hi = jnp.asarray(hi_h)
args = (pre["g"], pre["m"], pre["h"], scal, lo, hi, pre["usable"], dom_ok,
        pre["add_sd_zero"], jnp.asarray(blk_lo), jnp.asarray(blk_hi),
        jnp.float32(1e-4))
np.asarray(scal[:1])

idot = ld_int8.make_idot("int8")
n_f = jnp.float32(N)
adj_c = (n_f - 1.0) / (n_f - 2.0)


def dots_pass(gq, hq, scal_):
    def step(carry, b):
        r0 = b * B
        g_i = lax.dynamic_slice_in_dim(gq, r0, B, axis=0)
        h_i = lax.dynamic_slice_in_dim(hq, r0, B, axis=0)
        j0 = jnp.minimum(r0, M - right_rows)
        g_j = lax.dynamic_slice_in_dim(gq, j0, right_rows, axis=0)
        h_j = lax.dynamic_slice_in_dim(hq, j0, right_rows, axis=0)
        sgg = idot(g_i, g_j)
        sgh = idot(g_i, h_j)
        shg = idot(h_i, g_j)
        part = (jnp.sum(sgg, axis=1) + jnp.sum(sgh, axis=1)
                + jnp.sum(shg, axis=1)).astype(jnp.float32)
        return carry + jnp.sum(part), None

    tot, _ = lax.scan(step, jnp.float32(0.0),
                      jnp.arange(nb, dtype=jnp.int32))
    return tot


def epi_pass(gq, hq, scal_):
    def step(carry, b):
        r0 = b * B
        g_i = lax.dynamic_slice_in_dim(gq, r0, B, axis=0)
        h_i = lax.dynamic_slice_in_dim(hq, r0, B, axis=0)
        sc_i = ld_int8.scal_views(
            lax.dynamic_slice_in_dim(scal_, r0, B, axis=0), "col")
        j0 = jnp.minimum(r0, M - right_rows)
        g_j = lax.dynamic_slice_in_dim(gq, j0, right_rows, axis=0)
        h_j = lax.dynamic_slice_in_dim(hq, j0, right_rows, axis=0)
        sc_j = ld_int8.scal_views(
            lax.dynamic_slice_in_dim(scal_, j0, right_rows, axis=0), "row")
        r_add, r_da, r_db = ld_int8.corr_tiles(
            idot, g_i, None, h_i, g_j, None, h_j, sc_i, sc_j, n_f,
            jnp.float32(N), False, symmetric=True)
        adj_add = 1.0 - (1.0 - r_add * r_add) * adj_c
        adj_da = 1.0 - (1.0 - r_da * r_da) * adj_c
        adj_db = 1.0 - (1.0 - r_db * r_db) * adj_c
        gi = r0 + jnp.arange(B, dtype=jnp.int32)
        gj = j0 + jnp.arange(right_rows, dtype=jnp.int32)
        lo_i = lax.dynamic_slice_in_dim(lo, r0, B)[:, None]
        hi_i = lax.dynamic_slice_in_dim(hi, r0, B)[:, None]
        in_win = (gj[None, :] >= lo_i) & (gj[None, :] <= hi_i)
        row = in_win & (gj[None, :] >= r0) & (gj[None, :] != gi[:, None])
        col = in_win & (gj[None, :] >= r0 + B)
        part = (jnp.sum(adj_add * row, axis=1)
                + jnp.sum(adj_da * row, axis=1)
                + jnp.sum(adj_db * col, axis=1))
        return carry + jnp.sum(part), None

    tot, _ = lax.scan(step, jnp.float32(0.0),
                      jnp.arange(nb, dtype=jnp.int32))
    return tot


def make_chained(pass_fn):
    @jax.jit
    def chained(gq, hq, scal0):
        s = scal0
        tot = jnp.float32(0.0)
        for _ in range(Q):
            t = pass_fn(gq, hq, s)
            # dependency: perturb the scalars by an epsilon of the result
            s = s + (t * jnp.float32(1e-30))
            tot = tot + t
        return tot

    return chained


def timeit(name, fn, *a):
    np.asarray(fn(*a))                    # compile+warm
    t0 = time.time()
    np.asarray(fn(*a))
    dt = time.time() - t0
    print(f"(repeat {name}: {dt*1e3:.1f} ms)", flush=True)
    s2 = a[-1] + jnp.float32(1e-20)       # distinct input, defeat memo
    t0 = time.time()
    np.asarray(fn(*a[:-1], s2))
    dt = (time.time() - t0) / Q
    print(f"{name:8s}: {dt*1e3:7.1f} ms/pass  {M/dt:9,.0f} SNPs/s",
          flush=True)


timeit("dots", make_chained(dots_pass), pre["g"], pre["h"], scal)
timeit("epi", make_chained(epi_pass), pre["g"], pre["h"], scal)


@jax.jit
def full_chained(gq, hq, scal0):
    s = scal0
    tot = jnp.float32(0.0)
    for _ in range(Q):
        out = ld_int8.ld_scores_int8_sym(
            gq, gq, hq, s, lo, hi, pre["usable"], dom_ok,
            pre["add_sd_zero"], args[9], args[10], jnp.float32(1e-4),
            block_size=B, band_k=band_k, right_k=right_k, n_samples=N,
            has_missing=False, dot_dtype="int8")
        t = jnp.nansum(out[0])
        s = s + (t * jnp.float32(1e-30))
        tot = tot + t
    return tot


timeit("full", full_chained, pre["g"], pre["h"], scal)
