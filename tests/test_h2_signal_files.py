"""End-to-end h2 with real signal: genotypes -> phenotype-like Z scores
-> files -> estimate_h2, recovering a positive additive h2.
"""

import numpy as np
import pandas as pd

from nldsc_jax.h2.pipeline import estimate_h2
from nldsc_jax.io.plink import write_plink
from nldsc_jax.ld.pipeline import estimate_lds

from utils import make_positions, random_genotypes


def test_h2_signal_recovery_through_files(tmp_path):
    rng = np.random.default_rng(20260817)
    m, n = 1200, 600
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    bp = make_positions(m, spacing=500)
    prefix = write_plink(tmp_path / "sig", g, bp=bp.astype(np.int64))

    out = str(tmp_path / "sig.L2")
    estimate_lds(prefix, ld_wind=20, wind_metric="kbp", maf_thr=0.01,
                 std_thr=1e-4, out=out, extra=True, block_size=64)

    # simulate an additive phenotype on the actual genotypes
    h2_true = 0.5
    gf = g.astype(np.float64)
    x = (gf - gf.mean(1, keepdims=True)) / gf.std(1, keepdims=True)
    betas = rng.normal(0, np.sqrt(h2_true / m), size=m)
    genetic = betas @ x
    pheno = genetic + rng.normal(0, np.sqrt(1 - genetic.var()), size=n)
    pheno = (pheno - pheno.mean()) / pheno.std()

    # per-SNP GWAS Z ~= sqrt(N) * corr(x_j, pheno)
    corr = x @ pheno / n
    n_gwas = 60_000.0  # treat the correlation estimates as if from a big GWAS
    z = corr * np.sqrt(n_gwas)

    df = pd.read_csv(out, sep="\t")
    ss = pd.DataFrame({"SNP": df["SNP"], "Z": z, "N": n_gwas})
    ss_path = str(tmp_path / "sig.sumstats")
    ss.to_csv(ss_path, sep="\t", index=False)

    summary = estimate_h2(ss_path, out, n_blocks=40)
    est = summary["additive"]["hsq"]
    # correlations were computed in a small sample (n=600), so the
    # effective chi2 inflation is bounded; just assert strong signal
    # detection with the right order of magnitude and positive sign
    assert est > 0.1, est
    assert summary["additive"]["intercept"] > 0.5
