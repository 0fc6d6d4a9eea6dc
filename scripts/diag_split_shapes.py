"""Shape-space probe for the UKB-N split-corrections launch (r4 item 2).

The v2 corrections' big launch idot(g_x (S,N), cat3 (3P,N)) measured
~17 int8 Tops/s at N=300k while the clean scan's (256,N)@(N,1280) tiles
hit 259 — probe alternative formulations of the SAME contraction:

  base      — idot(g, cat3)                     (the current launch)
  bf16      — same, bf16 operands (exact: values <= 2, f32 accum)
  kchunk    — lax.scan over K chunks of 64k lanes, int32 accumulation
  swap      — idot(cat3, g) -> (3P, S) transposed output
  blocked   — lax.map over 256-row LHS blocks (scan-shaped outputs)
  bf16-prec — jnp.dot highest precision bf16x3? no: plain f32 dot

Usage: python scripts/diag_split_shapes.py [M] [N] [reps]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from nldsc_jax.ld import ld_int8

M = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
N = int(sys.argv[2]) if len(sys.argv) > 2 else 300032
REPS = int(sys.argv[3]) if len(sys.argv) > 3 else 3
P3 = 264  # 3 * p_band at the UKB config
N_PAD = -(-N // 128) * 128

key = jax.random.PRNGKey(0)


@jax.jit
def gen():
    g = jax.random.randint(key, (M, N_PAD), 0, 3, jnp.int8)
    c = jax.random.randint(jax.random.fold_in(key, 1), (P3, N_PAD), 0, 3,
                           jnp.int8)
    return g, c


idot = ld_int8.make_idot("int8")


def base(g, c):
    return idot(g, c).sum()            # on-device reduce: one scalar fetch
                                       # of a (M, 3P) result would dominate


def bf16(g, c):
    bdot = ld_int8.make_idot("bf16")
    return bdot(g, c).sum()


def kchunk(g, c, nk=8):
    kc = N_PAD // nk
    assert N_PAD % nk == 0 and kc % 128 == 0
    gr = g.reshape(M, nk, kc)
    cr = c.reshape(P3, nk, kc)

    def step(acc, k):
        gs = lax.dynamic_index_in_dim(gr, k, axis=1, keepdims=False)
        cs = lax.dynamic_index_in_dim(cr, k, axis=1, keepdims=False)
        return acc + idot(gs, cs), None

    acc0 = jnp.zeros((M, P3), jnp.float32)
    out, _ = lax.scan(step, acc0, jnp.arange(nk))
    return out.sum()


def swap(g, c):
    return idot(c, g).sum()


def stream(g, c):
    # raw memory-read baseline: stream the 1.2 GB LHS once, no matmul
    return g.astype(jnp.int32).sum()


def blocked(g, c, B=256):
    def blk(b):
        gs = lax.dynamic_slice_in_dim(g, b * B, B, axis=0)
        return idot(gs, c).sum()

    return lax.map(blk, jnp.arange(M // B, dtype=jnp.int32)).sum()


names = [("base", jax.jit(base)), ("bf16", jax.jit(bf16)),
         ("kchunk", jax.jit(kchunk)), ("swap", jax.jit(swap)),
         ("blocked", jax.jit(blocked)), ("stream", jax.jit(stream))]

g, c = gen()
np.asarray(g[:1, :1])
for nm, fn in names:
    np.asarray(fn(g, c))

flops = 2.0 * M * P3 * N_PAD
best = {nm: 1e9 for nm, _ in names}
for _ in range(REPS):
    for nm, fn in names:
        t0 = time.time()
        r = np.asarray(fn(g, c))
        best[nm] = min(best[nm], time.time() - t0)

for nm, _ in names:
    print(f"{nm:8s}: {best[nm]*1e3:8.2f} ms  {flops/best[nm]/1e12:6.1f} "
          f"Tops/s  ({1.23e9/best[nm]/1e9:5.1f} GB/s LHS stream)",
          flush=True)
