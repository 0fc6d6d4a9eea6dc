"""LD-score IO: directory mode, sidecar resolution, WSDE/WSA fallback."""

import numpy as np
import pandas as pd
import pytest

from nldsc_jax.io.ldscores import read_ld_scores, write_m_files


def _toy_l2(chrom, m, rng, extra=True):
    df = pd.DataFrame({
        "CHR": chrom,
        "SNP": [f"rs{chrom}_{i}" for i in range(m)],
        "BP": np.arange(1, m + 1) * 1000,
        "L2": rng.uniform(1, 30, m),
        "L2D": rng.uniform(0, 3, m),
    })
    if extra:
        df["MAF"] = rng.uniform(0.05, 0.5, m)
        df["WSA"] = rng.integers(10, 50, m)
        df["WSD"] = rng.integers(5, 40, m)
        df["WSDE"] = rng.integers(1, 10, m)
        df["RSTD"] = rng.uniform(0.1, 0.9, m)
    return df


def test_directory_mode_with_sidecars(tmp_path, rng):
    tot_m = 0
    for chrom in (1, 2, 3):
        df = _toy_l2(chrom, 50 + chrom, rng)
        path = tmp_path / f"chr{chrom}.L2"
        df.to_csv(path, sep="\t", index=False)
        result = {
            "l2": df["L2"].to_numpy(), "maf": df["MAF"].to_numpy(),
            "l2_ws": df["WSA"].to_numpy(), "l2d_wse": df["WSDE"].to_numpy(),
        }
        write_m_files(result, str(path))
        tot_m += 50 + chrom
    scores, m, md = read_ld_scores(str(tmp_path))
    assert len(scores) == tot_m
    assert m == tot_m
    assert 0 < md < tot_m
    # sorted by CHR, BP
    key = scores["CHR"] * 10**9 + scores["BP"]
    assert (np.diff(key) > 0).all()


def test_fallback_requires_extra_columns(tmp_path, rng):
    df = _toy_l2(9, 30, rng, extra=False)
    path = tmp_path / "bare.L2"
    df.to_csv(path, sep="\t", index=False)
    with pytest.raises(ValueError, match="extra"):
        read_ld_scores(str(path))


def test_fallback_wsde_wsa(tmp_path, rng):
    df = _toy_l2(7, 40, rng, extra=True)
    path = tmp_path / "fb.L2"
    df.to_csv(path, sep="\t", index=False)
    scores, m, md = read_ld_scores(str(path))
    assert m == 40
    expected_md = int(40 * (df["WSDE"] / df["WSA"]).mean())
    assert md == expected_md


def test_use_m_prefers_dot_m(tmp_path, rng):
    df = _toy_l2(5, 20, rng)
    path = tmp_path / "pick.L2"
    df.to_csv(path, sep="\t", index=False)
    pd.DataFrame({"M": [111], "MD": [22]}).to_csv(
        tmp_path / "pick.M", sep="\t", index=False)
    pd.DataFrame({"M": [999], "MD": [99]}).to_csv(
        tmp_path / "pick.M_5_50", sep="\t", index=False)
    _, m, md = read_ld_scores(str(path), use_m=True)
    assert (m, md) == (111, 22)
    _, m, md = read_ld_scores(str(path), use_m=False)
    assert (m, md) == (999, 99)


def test_sumstats_reader_variants(tmp_path, rng):
    import gzip

    from nldsc_jax.io.sumstats import read_sumstats

    df = pd.DataFrame({
        "SNP": [f"rs{i}" for i in range(50)] + ["rs0"],  # dup
        "Z": list(rng.normal(size=50)) + [1.0],
        "N": 1000.0,
        "A1": "A", "A2": "G",
    })
    df.loc[3, "Z"] = None  # NA row

    plain = tmp_path / "ss.sumstats"
    df.to_csv(plain, sep="\t", index=False, na_rep=".")
    out = read_sumstats(str(plain))
    assert len(out) == 49  # -1 NA, -1 dup
    assert list(out.columns) == ["SNP", "Z", "N"]

    out_alleles = read_sumstats(str(plain), alleles=True)
    assert {"A1", "A2"} <= set(out_alleles.columns)

    gz = tmp_path / "ss.sumstats.gz"
    with gzip.open(gz, "wt") as f:
        df.to_csv(f, sep="\t", index=False, na_rep=".")
    out_gz = read_sumstats(str(gz))
    assert out_gz.columns == out.columns
    for c in out.columns:
        np.testing.assert_array_equal(out_gz[c], out[c])
