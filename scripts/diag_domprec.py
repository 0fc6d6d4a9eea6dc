"""Diagnose the int8 engine's dominance-path precision (VERDICT r1 weak #2).

Runs the int8 engine vs the float64 oracle over many seeds on CPU and
reports the worst l2d error together with the minimum neighbor residual-sd
in each failing SNP's window — to confirm (or refute) the hypothesis that
f32 cancellation amplified by 1/rstd_j is the root cause.
"""

import os
os.environ["JAX_PLATFORMS"] = "cpu"

import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import numpy as np
from utils import make_positions, random_genotypes

from nldsc_jax.config import LDConfig
from nldsc_jax.ld.oracle import oracle_ld, preprocess
from nldsc_jax.ld.pipeline import compute_ld_scores

worst = []
for seed in range(40):
    rng = np.random.default_rng(seed)
    g = random_genotypes(rng, 200, 300, missing_rate=0.03)
    pos = make_positions(200, spacing=777, jitter_rng=rng)
    cfg = LDConfig(ld_wind=5000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=64)
    res = compute_ld_scores(g, pos, cfg)
    ora = oracle_ld(g, pos, cfg.ld_wind, cfg.maf_thr, cfg.std_thr, cfg.rsq_thr)
    err = np.abs(res["l2d"] - ora["l2d"])
    err_add = np.abs(res["l2"] - ora["l2"])
    i = np.nanargmax(err)
    pre = preprocess(g, pos, cfg.maf_thr)
    in_win = np.abs(pos - pos[i]) <= cfg.ld_wind
    nbr = in_win & pre.usable
    nbr[i] = False
    rstds = pre.residuals_sd[np.flatnonzero(nbr)]
    rstds = rstds[rstds > cfg.std_thr]
    min_rstd = rstds.min() if len(rstds) else np.nan
    worst.append((np.nanmax(err), np.nanmax(err_add), seed, i, min_rstd))

worst.sort(reverse=True)
print("top-10 worst l2d errors (err_l2d, err_l2, seed, snp, min nbr rstd):")
for w in worst[:10]:
    print(f"  l2d={w[0]:.3e}  l2={w[1]:.3e}  seed={w[2]:3d} snp={w[3]:3d} "
          f"min_rstd={w[4]:.3e}")
