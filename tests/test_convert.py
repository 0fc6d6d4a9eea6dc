"""LD format converter (reference C20 stub, implemented): round-trips
between .L2 and ldsc .l2.ldscore.gz, and h2 consumption of converted files.
"""

import gzip

import numpy as np
import pandas as pd
import pytest

from nldsc_jax.io.convert import from_ldsc, to_ldsc
from nldsc_jax.io.ldscores import read_ld_scores


def _toy_l2(tmp_path, m=300, seed=4):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "CHR": 22, "SNP": [f"rs{i}" for i in range(m)],
        "BP": np.arange(m) * 400 + 100,
        "L2": rng.uniform(1, 8, m).round(5),
        "L2D": rng.uniform(0, 1, m).round(5),
    })
    p = tmp_path / "t.L2"
    df.to_csv(p, sep="\t", index=False, float_format="%.5f")
    pd.DataFrame({"M": [m - 7], "MD": [42]}).to_csv(
        p.with_suffix(".M_5_50"), sep="\t", index=False)
    pd.DataFrame({"M": [m], "MD": [50]}).to_csv(
        p.with_suffix(".M"), sep="\t", index=False)
    return p, df


def test_roundtrip_to_from_ldsc(tmp_path):
    p, df = _toy_l2(tmp_path)
    prefix = str(tmp_path / "conv")
    to_ldsc(str(p), prefix)

    # ldsc-side files exist and carry the right shapes
    with gzip.open(f"{prefix}.l2.ldscore.gz", "rt") as f:
        head = f.readline().split()
    assert head == ["CHR", "SNP", "BP", "L2"]
    assert open(f"{prefix}.l2.M_5_50").read().strip() == str(300 - 7)
    assert open(f"{prefix}.d.l2.M_5_50").read().strip() == "42"
    dom = pd.read_csv(f"{prefix}.d.l2.ldscore.gz", sep="\t")
    np.testing.assert_allclose(dom["L2"], df["L2D"], atol=1e-5)

    # back-convert: additive scores and M survive exactly
    out = tmp_path / "back.L2"
    from_ldsc(prefix, str(out))
    back = pd.read_csv(out, sep="\t")
    np.testing.assert_allclose(back["L2"], df["L2"], atol=1e-5)
    assert (back["L2D"] == 0).all()
    scores, m, md = read_ld_scores(str(out))
    assert m == 300 - 7 and md == 0


def test_from_ldsc_uncompressed_and_h2(tmp_path):
    # headerless multi-annotation .l2.M is summed; uncompressed input works;
    # the converted file feeds the h2 pipeline (additive part meaningful)
    rng = np.random.default_rng(9)
    m, n_ind = 3000, 40000.0
    l2 = rng.uniform(1, 30, m)
    tab = pd.DataFrame({"CHR": 1, "SNP": [f"s{i}" for i in range(m)],
                        "BP": np.arange(m), "L2": l2})
    prefix = str(tmp_path / "u")
    tab.to_csv(f"{prefix}.l2.ldscore", sep="\t", index=False)
    with open(f"{prefix}.l2.M_5_50", "w") as f:
        f.write("2000\t800\n")  # multi-annotation counts sum to M
    out = str(tmp_path / "u.L2")
    from_ldsc(prefix, out)
    scores, M, MD = read_ld_scores(out)
    assert M == 2800 and MD == 0

    from nldsc_jax.config import H2Config
    from nldsc_jax.h2.pipeline import estimate_h2_frames

    h2_true = 0.3
    expect = 1.0 + n_ind * h2_true * l2 / 2800
    chisq = np.clip(expect * rng.chisquare(1, m), 1e-8, None)
    ss = pd.DataFrame({"SNP": tab["SNP"], "Z": np.sqrt(chisq), "N": n_ind})
    res = estimate_h2_frames(ss, scores, 2800, 1,
                             H2Config(n_blocks=40, chisq_max=1e9))
    s = res["summary"]["additive"]
    assert abs(s["hsq"] - h2_true) < 4 * s["hsq.std"] + 0.05


def test_convert_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        from_ldsc(str(tmp_path / "nope"), str(tmp_path / "x.L2"))
    bad = tmp_path / "bad.L2"
    pd.DataFrame({"SNP": ["a"], "L2": [1.0]}).to_csv(bad, sep="\t", index=False)
    with pytest.raises(ValueError, match="columns"):
        to_ldsc(str(bad), str(tmp_path / "p"))
