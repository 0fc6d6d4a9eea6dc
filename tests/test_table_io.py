"""The NumPy table IO writes and reads the .L2/.M/sumstats formats
exactly as the pandas calls it replaced did."""

import numpy as np
import pandas as pd
import pytest

from nldsc_jax.h2.pipeline import merge_ld_sumstats
from nldsc_jax.io.ldscores import make_output, write_l2, write_m_files
from nldsc_jax.io.table import Table, read_table


def _result(rng, m):
    res = {
        "l2": rng.uniform(0.5, 40.0, m), "l2d": rng.normal(0.0, 0.3, m),
        "maf": rng.uniform(0.0, 0.5, m),
        "residuals_std": rng.uniform(0.1, 1.0, m),
        "l2_ws": rng.integers(0, 3000, m), "l2d_ws": rng.integers(0, 3000, m),
        "l2d_wse": rng.integers(0, 300, m),
    }
    dead = rng.choice(m, m // 10, replace=False)   # unusable SNPs
    for k in ("l2", "l2d", "residuals_std"):
        res[k][dead] = np.nan
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        res[k][dead] = -1
    res["l2d"][dead[:3]] = 0.0
    res["l2"][:2] = [-0.0, 1e-9]
    return res


@pytest.mark.parametrize("extra", [False, True])
def test_l2_writer_matches_pandas(tmp_path, extra):
    rng = np.random.default_rng(11)
    m = 500
    bim = Table({"CHR": np.full(m, 22), "SNP": np.array(
        [f"rs{i}" for i in range(m)], dtype=object),
        "BP": np.arange(1, m + 1) * 100})
    res = _result(rng, m)
    ours = tmp_path / "ours.L2"
    write_l2(make_output(bim, res, extra=extra), str(ours))
    theirs = tmp_path / "theirs.L2"
    make_output(bim, res, extra=extra).to_pandas().to_csv(
        theirs, sep="\t", index=False, float_format="%.5f")
    assert ours.read_bytes() == theirs.read_bytes()

    write_m_files(res, str(ours))
    for suffix in (".M", ".M_5_50"):
        m_row = pd.read_csv(ours.with_suffix(suffix), sep="\t")
        pd.DataFrame({"M": m_row["M"], "MD": m_row["MD"]}).to_csv(
            theirs.with_suffix(suffix), sep="\t", index=False)
        assert (ours.with_suffix(suffix).read_bytes()
                == theirs.with_suffix(suffix).read_bytes())


@pytest.mark.parametrize("sep", ["\t", " "])
def test_readers_and_join_match_pandas(tmp_path, sep):
    rng = np.random.default_rng(12)
    m = 300
    snps = [f"rs{i}" for i in rng.permutation(m)]
    ld = pd.DataFrame({"CHR": rng.integers(1, 3, m), "SNP": snps,
                       "BP": rng.integers(1, 10**6, m),
                       "L2": rng.uniform(1, 9, m), "L2D": rng.normal(size=m)})
    ld.loc[5, "L2"] = np.nan
    ss = pd.DataFrame({"SNP": [snps[i] for i in rng.choice(m, 200)],
                       "Z": rng.normal(size=200), "N": 1e4})
    ss = ss.drop_duplicates(subset="SNP")
    for name, df in (("ld", ld), ("ss", ss)):
        path = tmp_path / f"{name}.txt"
        df.to_csv(path, sep=sep, index=False, float_format="%.6f",
                  na_rep="NA")
        pd_sep = "\t" if sep == "\t" else r"\s+"
        want = pd.read_csv(path, sep=pd_sep)
        got = read_table(path, sep="\t" if sep == "\t" else None)
        assert got.columns == list(want.columns)
        for c in want.columns:
            a, b = np.asarray(got[c]), want[c].to_numpy()
            if b.dtype.kind == "f":
                np.testing.assert_array_equal(a.astype(float), b)
            else:
                assert a.tolist() == b.tolist(), c
    joined = merge_ld_sumstats(read_table(tmp_path / "ss.txt",
                                          sep="\t" if sep == "\t" else None),
                               read_table(tmp_path / "ld.txt",
                                          sep="\t" if sep == "\t" else None))
    want = pd.merge(ss, ld, how="inner", on="SNP")
    assert list(joined["SNP"]) == list(want["SNP"])
    np.testing.assert_allclose(joined["L2"], want["L2"], atol=1e-6,
                               equal_nan=True)
