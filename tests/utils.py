"""Synthetic genotype data for tests: adversarial but reproducible."""

from __future__ import annotations

import contextlib
import io
from types import SimpleNamespace

import numpy as np


def random_genotypes(rng: np.random.Generator, m: int, n: int,
                     missing_rate: float = 0.02,
                     maf_low: float = 0.01, maf_high: float = 0.5,
                     ld_blocks: bool = True) -> np.ndarray:
    """int8 (m, n) genotypes with realistic MAF spectrum and local LD."""
    mafs = rng.uniform(maf_low, maf_high, size=m)
    if ld_blocks:
        # correlated neighboring SNPs: copy-with-mutation chains
        g = np.empty((m, n), dtype=np.int8)
        g[0] = rng.binomial(2, mafs[0], size=n)
        for i in range(1, m):
            if rng.random() < 0.7:
                flip = rng.random(n) < 0.2
                resample = rng.binomial(2, mafs[i], size=n)
                g[i] = np.where(flip, resample, g[i - 1])
            else:
                g[i] = rng.binomial(2, mafs[i], size=n)
    else:
        g = rng.binomial(2, mafs[:, None], size=(m, n)).astype(np.int8)
    if missing_rate > 0:
        miss = rng.random((m, n)) < missing_rate
        g = np.where(miss, np.int8(-1), g).astype(np.int8)
    return g.astype(np.int8)


def adversarial_genotypes(rng: np.random.Generator, n: int) -> np.ndarray:
    """Edge-case SNP rows: monomorphic, all-het, rare, heavy-missing."""
    rows = [
        np.zeros(n, dtype=np.int8),                         # monomorphic 0 (maf 0)
        np.full(n, 2, dtype=np.int8),                       # monomorphic 2 (maf 0)
        np.ones(n, dtype=np.int8),                          # all-het: sd=0, maf=.5
        rng.binomial(2, 0.001, size=n).astype(np.int8),     # ultra-rare
        rng.binomial(2, 0.3, size=n).astype(np.int8),       # normal
    ]
    heavy_missing = rng.binomial(2, 0.25, size=n).astype(np.int8)
    heavy_missing[: n // 2] = -1
    rows.append(heavy_missing)
    return np.stack(rows)


def make_positions(m: int, spacing: int = 1000, jitter_rng=None,
                   skip_idx=()) -> np.ndarray:
    """Sorted bp positions with optional negative skip sentinels."""
    bp = np.arange(1, m + 1, dtype=np.float64) * spacing
    if jitter_rng is not None:
        bp += jitter_rng.integers(0, spacing // 2, size=m)
        bp = np.sort(bp)
    for i in skip_idx:
        bp[i] = -1.0
    return bp


def run_cli(argv: list[str]) -> SimpleNamespace:
    """Run the CLI in-process; ``exit_code`` and captured stdout
    ``output`` (argparse usage errors exit through SystemExit)."""
    from nldsc_jax.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            code = main(argv)
        except SystemExit as ex:
            code = ex.code
    return SimpleNamespace(exit_code=code, output=buf.getvalue())
