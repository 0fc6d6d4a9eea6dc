"""Decompose the UKB-N split-corrections cost (VERDICT r3 #2).

Times, each as its own jitted dispatch with device-resident inputs and a
result fetch (min of alternating reps, compare ratios):

  clean    — the untouched symmetric clean scan
  corr     — the full split_corrections kernel
  a_t      — idot(g_x, cat3)            (the big S×3P launch)
  b_t      — idot(h_x, cat3[:2P])       (the second big launch)
  epi      — corrections minus the two big launches (dots precomputed)

Usage: python scripts/diag_split_ukb.py [M] [N] [reps]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp

from nldsc_jax.ld import ld_int8, ld_split, windows

M = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
N = int(sys.argv[2]) if len(sys.argv) > 2 else 300032
REPS = int(sys.argv[3]) if len(sys.argv) > 3 else 3
W, B = 1000, 256
SPACING = 100.0

pos = np.arange(1, M + 1, dtype=np.float64) * SPACING
lo, hi, pos_ok = windows.window_bounds(pos, W * SPACING)
blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, M // B)
right_k = windows.right_band_blocks(blk_hi, B)
meta = (jnp.asarray(pos_ok), jnp.asarray(lo), jnp.asarray(hi))

rowmiss_h = np.zeros(M, dtype=bool)
rowmiss_h[::50] = True
plan = ld_split.plan_split_v2(rowmiss_h, lo, hi,
                              min(ld_split.SEG_ROWS_DEFAULT, M), M)
rowmiss_dev = jnp.asarray(rowmiss_h)
P, PX = plan["p_band"], plan["p_x"]
print(f"M={M} N={N} B={B} right_k={right_k} p_band={P} p_x={PX} "
      f"n_segs={plan['n_segs']}")


@jax.jit
def gen(key):
    g = jax.random.randint(key, (M, N), 0, 3, jnp.int8)
    mk = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.05, (M, N))
    mk = mk & jnp.asarray(rowmiss_h)[:, None]
    return jnp.where(mk, jnp.int8(-1), g)


@jax.jit
def prep(g_dev):
    pre = ld_int8.preprocess_int8(g_dev, meta[0], jnp.float32(0.01),
                                  n_samples=N, materialize_m=False)
    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
    m_c = ld_split.compact_missing_rows(g_dev, jnp.asarray(plan["miss_idx"]))
    return (pre["g"], m_c, pre["h"], ld_int8.stack_scalars(pre),
            pre["usable"], dom_ok, pre["add_sd_zero"])


def clean_fn(g, m_c, h, scal, usable, dom_ok, poison):
    accs = ld_int8.sym_scan_segment(
        g, g, h, scal, meta[1], meta[2], usable, dom_ok, poison,
        jnp.float32(1e-4), jnp.int32(0), block_size=B, right_k=right_k,
        n_samples=N, n_scan_blocks=M // B, has_missing=False,
        dot_dtype="int8")
    return accs[0]


def corr_fn(g, m_c, h, scal, usable, dom_ok, poison):
    out = ld_split.split_corrections(
        g, m_c, h, scal, meta[1], meta[2], usable, dom_ok, rowmiss_dev,
        jnp.float32(1e-4), jnp.int32(M), jnp.asarray(plan["miss_idx"]),
        jnp.asarray(plan["cs"]), jnp.asarray(plan["c_cnt"]),
        jnp.asarray(plan["xs"]), jnp.asarray(plan["x_cnt"]),
        seg_rows=plan["seg_rows"], n_segs=plan["n_segs"],
        p_band=P, p_x=PX, n_samples=N, dot_dtype="int8")
    return out[0]


def a_fn(g, m_c, h, scal, usable, dom_ok, poison):
    idot = ld_int8.make_idot("int8")
    g_c = jnp.take(g, jnp.asarray(plan["miss_idx"][:P]), axis=0)
    h_c = jnp.take(h, jnp.asarray(plan["miss_idx"][:P]), axis=0)
    cat3 = jnp.concatenate([g_c, m_c[:P], h_c], axis=0)
    return idot(g, cat3)[:, 0]


def b_fn(g, m_c, h, scal, usable, dom_ok, poison):
    idot = ld_int8.make_idot("int8")
    g_c = jnp.take(g, jnp.asarray(plan["miss_idx"][:P]), axis=0)
    cat2 = jnp.concatenate([g_c, m_c[:P]], axis=0)
    return idot(h, cat2)[:, 0]


def ab_fused_fn(g, m_c, h, scal, usable, dom_ok, poison):
    """Both big launches in ONE dot_general via an on-device stack of
    (g, h) — measures whether a single 2S-row sweep beats two S sweeps."""
    idot = ld_int8.make_idot("int8")
    g_c = jnp.take(g, jnp.asarray(plan["miss_idx"][:P]), axis=0)
    h_c = jnp.take(h, jnp.asarray(plan["miss_idx"][:P]), axis=0)
    cat3 = jnp.concatenate([g_c, m_c[:P], h_c], axis=0)
    gh = jnp.concatenate([g, h], axis=0)
    return idot(gh, cat3)[:, 0]


names = [("clean", jax.jit(clean_fn)), ("corr", jax.jit(corr_fn)),
         ("a_t", jax.jit(a_fn)), ("b_t", jax.jit(b_fn)),
         ("a+b fused", jax.jit(ab_fused_fn))]

g_dev = gen(jax.random.PRNGKey(1))
args = prep(g_dev)
np.asarray(args[0][:1, :1])
for nm, fn in names:               # warm compiles
    np.asarray(fn(*args))

best = {nm: 1e9 for nm, _ in names}
for _ in range(REPS):
    for nm, fn in names:
        t0 = time.time()
        np.asarray(fn(*args))
        best[nm] = min(best[nm], time.time() - t0)

for nm, _ in names:
    print(f"{nm:10s}: {best[nm]*1e3:8.2f} ms   ({M/best[nm]:10,.0f} SNPs/s)",
          flush=True)
print(f"clean+corr = {(best['clean']+best['corr'])*1e3:.1f} ms "
      f"({M/(best['clean']+best['corr']):,.0f} SNPs/s)")
