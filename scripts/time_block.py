"""Block-size sweep under the one-dispatch protocol (bench.py shape).

Smaller B cuts band quantization waste (right_rows = right_k*B ≈ W+B)
but lengthens the scan; this finds the sweet spot on hardware.
Usage: python scripts/time_block.py
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp

from nldsc_jax.ld import ld_int8, windows

M_SEG, N, W = 16384, 16384, 1000
SEGMENTS = 4
SPACING = 100.0
m_total = SEGMENTS * M_SEG

seg = np.arange(1, M_SEG + 1, dtype=np.float64) * SPACING
pos = np.concatenate([seg + i * 1e9 for i in range(SEGMENTS)])


@jax.jit
def gen(key):
    return jax.random.randint(key, (m_total, N), 0, 3, jnp.int8)


g_warm, g_time = gen(jax.random.PRNGKey(1)), gen(jax.random.PRNGKey(2))
np.asarray(g_warm[:1, :1])
np.asarray(g_time[:1, :1])

for B in (128, 256, 512):
    lo, hi, pos_ok = windows.window_bounds(pos, W * SPACING)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, m_total // B)
    right_k = windows.right_band_blocks(blk_hi, B)
    meta = (jnp.asarray(pos_ok), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(blk_lo), jnp.asarray(blk_hi))

    @jax.jit
    def full_pass(g_dev, B=B, band_k=band_k, right_k=right_k, meta=meta):
        pre = ld_int8.preprocess_int8(g_dev, meta[0], jnp.float32(0.01),
                                      n_samples=N, assume_no_missing=True)
        dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
        out = ld_int8.ld_scores_int8_sym(
            pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            meta[1], meta[2], pre["usable"], dom_ok, pre["add_sd_zero"],
            meta[3], meta[4], jnp.float32(1e-4), block_size=B,
            band_k=band_k, right_k=right_k, n_samples=N,
            has_missing=False, dot_dtype="int8")
        return out[0]

    np.asarray(full_pass(g_warm))
    t0 = time.time()
    l2 = np.asarray(full_pass(g_time))
    dt = time.time() - t0
    assert np.isfinite(l2).sum() > m_total * 0.9
    ops = 3 * 2.0 * m_total * right_k * B * N
    print(f"B={B:4d} right_rows={right_k*B:5d}: {dt*1e3:7.1f} ms "
          f"{m_total/dt:9,.0f} SNPs/s  ({ops/dt/1e12:5.1f} Tops actual)",
          flush=True)
