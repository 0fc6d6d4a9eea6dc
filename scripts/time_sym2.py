"""Time int8 engine variants (full-band / sym scan / sym2 two-pass) on the
real chip, with and without missing genotypes.

Usage: python scripts/time_sym2.py [M] [N] [win_snps] [B]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax.numpy as jnp

from nldsc_jax.ld import ld_int8, windows

M = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
N = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
W = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
B = int(sys.argv[4]) if len(sys.argv) > 4 else 256
SPACING = 100.0


def setup(seed, missing_rate):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(M, N), dtype=np.int8)
    if missing_rate:
        g[rng.random((M, N)) < missing_rate] = -1
    pos = np.arange(1, M + 1, dtype=np.float64) * SPACING
    lo, hi, pos_ok = windows.window_bounds(pos, W * SPACING)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, M // B)
    right_k = windows.right_band_blocks(blk_hi, B)
    pre = ld_int8.preprocess_int8(jnp.asarray(g), jnp.asarray(pos_ok),
                                  jnp.float32(0.01), n_samples=N)
    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
    args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            jnp.asarray(lo), jnp.asarray(hi),
            pre["usable"], dom_ok, pre["add_sd_zero"],
            jnp.asarray(blk_lo), jnp.asarray(blk_hi), jnp.float32(1e-4))
    np.asarray(args[0][:2])  # force staging
    return args, band_k, right_k


def run(fn, args, **kw):
    out = fn(*args, **kw)
    l2 = np.asarray(out[0])
    assert np.isfinite(l2).sum() > M * 0.9
    return l2


useful = 4.0 * M * (2 * W) * N

for miss in (0.0, 0.02):
    args_w, band_k, right_k = setup(1, miss)
    args_t, _, _ = setup(2, miss)
    hm = miss > 0
    variants = [
        ("full", ld_int8.ld_scores_int8,
         dict(block_size=B, band_k=band_k, n_samples=N, has_missing=hm)),
        ("sym ", ld_int8.ld_scores_int8_sym,
         dict(block_size=B, band_k=band_k, right_k=right_k, n_samples=N,
              has_missing=hm)),
        ("sym2", ld_int8.ld_scores_int8_sym2,
         dict(block_size=B, right_k=right_k, n_samples=N, has_missing=hm)),
    ]
    ref = None
    for name, fn, kw in variants:
        run(fn, args_w, **kw)             # compile + warm
        t0 = time.time()
        l2 = run(fn, args_t, **kw)        # timed, different data
        dt = time.time() - t0
        if ref is None:
            ref = l2
        else:
            d = np.nanmax(np.abs(l2 - ref))
            assert d < 1e-3, f"{name} mismatch {d}"
        print(f"miss={miss:.2f} {name}: {dt:6.3f}s {M/dt:9,.0f} SNPs/s "
              f"{useful/dt/1e12:6.2f} TF/s")
