"""Partitioned (annot) vs unpartitioned symmetric-engine rate on the chip.

VERDICT r2 item 5 done-criterion: annot through the symmetric engine
within ~10% of the unpartitioned rate.  One dispatch per variant over
the full bench shape (8×16384-SNP segments — enough work to swamp the
~28 ms fixed dispatch constant), N=16384, ±1000-SNP window, clean data,
annotation width p=4.  Usage: python scripts/time_annot.py
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax
import jax.numpy as jnp

from nldsc_jax.ld import ld_int8, windows

N, W, B, P = 16384, 1000, 512, 4
SEGMENTS, SEG_M = 8, 16384
M = SEGMENTS * SEG_M
SPACING = 100.0

seg = np.arange(1, SEG_M + 1, dtype=np.float64) * SPACING
pos = np.concatenate([seg + i * 1e9 for i in range(SEGMENTS)])
lo, hi, pos_ok = windows.window_bounds(pos, W * SPACING)
blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, M // B)
right_k = windows.right_band_blocks(blk_hi, B)
meta = (jnp.asarray(pos_ok), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(blk_lo), jnp.asarray(blk_hi))

rng = np.random.default_rng(0)
annot_h = np.column_stack(
    [np.ones(M)] + [(rng.random(M) < 0.3).astype(np.float64)
                    for _ in range(P - 1)]).astype(np.float32)


@jax.jit
def gen(key):
    return jax.random.randint(key, (M, N), 0, 3, jnp.int8)


# alternate the two variants over several reps on distinct inputs and
# report the MIN, which tracks device time
REPS = 3


def make_pass(annot):
    @jax.jit
    def full_pass(g_dev):
        pre = ld_int8.preprocess_int8(g_dev, meta[0], jnp.float32(0.01),
                                      n_samples=N, assume_no_missing=True)
        dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
        out = ld_int8.ld_scores_int8_sym(
            pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            meta[1], meta[2], pre["usable"], dom_ok, pre["add_sd_zero"],
            meta[3], meta[4], jnp.float32(1e-4), annot, block_size=B,
            band_k=band_k, right_k=right_k, n_samples=N,
            has_missing=False, dot_dtype="int8")
        return out[0]
    return full_pass


def make_fullband(annot):
    @jax.jit
    def full_pass(g_dev):
        pre = ld_int8.preprocess_int8(g_dev, meta[0], jnp.float32(0.01),
                                      n_samples=N, assume_no_missing=True)
        dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
        out = ld_int8.ld_scores_int8(
            pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            meta[1], meta[2], pre["usable"], dom_ok, pre["add_sd_zero"],
            meta[3], meta[4], jnp.float32(1e-4), annot, block_size=B,
            band_k=band_k, n_samples=N, has_missing=False,
            dot_dtype="int8")
        return out[-5]
    return full_pass


def make_split_annot(annot):
    """annot × split-missing (r4): clean symmetric annot scan + annot
    δ-corrections — the route the pipeline selects for annot data with
    a minority of contaminated rows (done-criterion: within ~1.5× of
    clean annot)."""
    from nldsc_jax.ld import ld_split

    rowmiss_h = np.zeros(M, dtype=bool)
    rowmiss_h[::50] = True
    plan = ld_split.plan_split_v2(rowmiss_h, lo, hi,
                                  min(ld_split.SEG_ROWS_DEFAULT, M), M)
    sd = tuple(jnp.asarray(plan[k]) for k in
               ("miss_idx", "cs", "c_cnt", "xs", "x_cnt"))
    rowmiss_dev = jnp.asarray(rowmiss_h)

    @jax.jit
    def full_pass(g_dev):
        mk = (g_dev == 1) & rowmiss_dev[:, None] & \
            (jax.lax.broadcasted_iota(jnp.int32, g_dev.shape, 1) % 20 == 0)
        g_miss = jnp.where(mk, jnp.int8(-1), g_dev)
        pre = ld_int8.preprocess_int8(g_miss, meta[0], jnp.float32(0.01),
                                      n_samples=N, materialize_m=False)
        dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
        scal = ld_int8.stack_scalars(pre)
        accs = ld_int8.sym_scan_segment(
            pre["g"], pre["g"], pre["h"], scal, meta[1], meta[2],
            pre["usable"], dom_ok, pre["add_sd_zero"], jnp.float32(1e-4),
            jnp.int32(0), annot, block_size=B, right_k=right_k,
            n_samples=N, n_scan_blocks=M // B, has_missing=False,
            dot_dtype="int8")
        m_c = ld_split.compact_missing_rows(g_miss, sd[0])
        deltas = ld_split.split_corrections(
            pre["g"], m_c, pre["h"], scal, meta[1], meta[2],
            pre["usable"], dom_ok, rowmiss_dev, jnp.float32(1e-4),
            jnp.int32(M), *sd, annot,
            seg_rows=plan["seg_rows"], n_segs=plan["n_segs"],
            p_band=plan["p_band"], p_x=plan["p_x"], n_samples=N,
            dot_dtype="int8")
        return accs[6] + deltas[3]          # l2_annot credits
    return full_pass


passes = {"plain": make_pass(None),
          f"annot p={P}": make_pass(jnp.asarray(annot_h)),
          f"fullband annot p={P}": make_fullband(jnp.asarray(annot_h)),
          f"annot p={P} split 2% rows": make_split_annot(
              jnp.asarray(annot_h))}
g_in = [gen(jax.random.PRNGKey(k)) for k in range(REPS + 1)]
for g in g_in:
    np.asarray(g[:1, :1])
for name, fp in passes.items():
    np.asarray(fp(g_in[0]))                # compile + warm
times = {name: [] for name in passes}
for rep in range(1, REPS + 1):
    for name, fp in passes.items():
        t0 = time.time()
        res = np.asarray(fp(g_in[rep]))
        times[name].append(time.time() - t0)
        assert np.isfinite(res).sum() > 0
for name, ts in times.items():
    dt = min(ts)
    print(f"sym int8 {name:10s}: min {dt*1e3:7.1f} ms  {M/dt:9,.0f} SNPs/s "
          f"(reps: {', '.join(f'{t*1e3:.0f}' for t in ts)})", flush=True)
