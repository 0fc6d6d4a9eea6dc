"""Scan f32 LD-kernel block sizes on a GPU with device-resident inputs.

Each config is warmed on one input and timed on another, with a result
fetch ending the timed region.

Usage: python scripts/tune_ld.py [M] [N] [win_snps]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from nldsc_jax.ld import ld_xla, preprocess, windows


def setup(m, n, win_snps, B, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(m, n), dtype=np.int8)
    pos = np.arange(1, m + 1, dtype=np.float64) * 100.0
    wind = win_snps * 100.0
    n_pad = -(-n // 128) * 128
    if n_pad != n:
        g = np.concatenate([g, np.full((m, n_pad - n), -1, np.int8)], axis=1)
    lo, hi, pos_ok = windows.window_bounds(pos, wind)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, m // B)
    pre = preprocess.preprocess_block(
        jnp.asarray(g), jnp.asarray(pos_ok), jnp.float32(0.01), n_samples=n)
    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
    args = (pre["add"], pre["res"], jnp.asarray(lo), jnp.asarray(hi),
            pre["usable"], dom_ok, pre["add_sd_zero"],
            jnp.asarray(blk_lo), jnp.asarray(blk_hi))
    return args, band_k


def fetch(out):
    return np.asarray(out[0])[:8]


def main():
    argv = [int(a) for a in sys.argv[1:]]
    m = argv[0] if argv else 8192
    n = argv[1] if len(argv) > 1 else 4096
    w = argv[2] if len(argv) > 2 else 1000

    useful_flops = 4.0 * m * (2 * w) * n

    for B in (256, 512):
        args_w, band_k = setup(m, n, w, B, seed=1)
        args_t, _ = setup(m, n, w, B, seed=2)
        kw = dict(block_size=B, band_k=band_k, n_samples=n)
        fetch(ld_xla.ld_scores_xla(*args_w, jnp.float32(1e-4), **kw))
        t0 = time.time()
        fetch(ld_xla.ld_scores_xla(*args_t, jnp.float32(1e-4), **kw))
        dt = time.time() - t0
        print(f"xla    B={B:4d}: {dt:6.3f}s {m / dt:9,.0f} SNPs/s  "
              f"{useful_flops / dt / 1e12:6.2f} TF/s")


if __name__ == "__main__":
    main()
