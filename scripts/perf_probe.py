"""Quick single-chip perf probe: SNPs/s for the banded LD pass.

Usage: python scripts/perf_probe.py [M] [N] [window_snps] [block]
"""

import sys
import time

import numpy as np
import jax

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

from nldsc_jax.config import LDConfig
from nldsc_jax.ld.pipeline import compute_ld_scores


def run(m=8192, n=4096, win_snps=1000, block=256):
    rng = np.random.default_rng(0)
    g = rng.integers(0, 3, size=(m, n), dtype=np.int8)
    pos = np.arange(1, m + 1, dtype=np.float64) * 100.0
    wind = win_snps * 100.0
    cfg = LDConfig(ld_wind=min(wind, 5e6), wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-4, block_size=block)
    # warmup (compile)
    t0 = time.time()
    compute_ld_scores(g, pos, cfg)
    t_compile = time.time() - t0
    t0 = time.time()
    res = compute_ld_scores(g, pos, cfg)
    dt = time.time() - t0
    flops = 4.0 * m * (2 * win_snps) * n  # add+dom, mul+add
    print(f"M={m} N={n} W=±{win_snps} B={block}: "
          f"{dt:.3f}s ({t_compile:.1f}s first), {m / dt:,.0f} SNPs/s, "
          f"~{flops / dt / 1e12:.2f} eff TFLOP/s")
    return res, dt


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    m = args[0] if len(args) > 0 else 8192
    n = args[1] if len(args) > 1 else 4096
    w = args[2] if len(args) > 2 else 1000
    b = args[3] if len(args) > 3 else 256
    run(m, n, w, b)
