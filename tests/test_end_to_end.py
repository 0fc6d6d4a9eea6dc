"""End-to-end: bfile -> estimate_lds -> .L2/.M files -> estimate_h2 -> JSON.

Also exercises the CLI via click's test runner.
"""

import json

import numpy as np
import pandas as pd
import pytest

from utils import make_positions, random_genotypes


@pytest.fixture(scope="module")
def toy_bfile(tmp_path_factory):
    from nldsc_jax.io.plink import write_plink

    rng = np.random.default_rng(7)
    m, n = 400, 250
    g = random_genotypes(rng, m, n, missing_rate=0.02)
    bp = make_positions(m, spacing=500, jitter_rng=rng)
    prefix = write_plink(tmp_path_factory.mktemp("e2e") / "chr22", g, bp=bp)
    return prefix, g, bp, rng


def test_ld_pipeline_files(toy_bfile, tmp_path):
    from nldsc_jax.ld.pipeline import estimate_lds

    prefix, g, bp, _ = toy_bfile
    out = str(tmp_path / "chr22.L2")
    estimate_lds(prefix, ld_wind=10, wind_metric="kbp", maf_thr=0.01,
                 std_thr=1e-4, out=out, extra=True, block_size=64)

    df = pd.read_csv(out, sep="\t")
    assert list(df.columns) == ["CHR", "SNP", "BP", "L2", "L2D",
                                "MAF", "WSA", "WSD", "WSDE", "RSTD"]
    assert len(df) == 400
    assert df["L2"].notna().sum() > 350

    m_df = pd.read_csv(str(tmp_path / "chr22.M_5_50"), sep="\t")
    assert {"M", "MD"} == set(m_df.columns)
    assert 0 < int(m_df["M"].iloc[0]) <= 400

    # parity of the file contents vs oracle at the written precision
    from nldsc_jax.ld.oracle import oracle_ld

    ora = oracle_ld(g, bp, 10000.0, 0.01, 1e-4, 1.0 / 400)
    np.testing.assert_allclose(df["L2"].to_numpy(), ora["l2"],
                               atol=2e-4, equal_nan=True)

    # stage decomposition recorded for the LAST run (r5, VERDICT r4 #6):
    # bench.py emits these so a slow e2e figure is attributable.  The
    # single-device in-core route records all four stages (the bench
    # path); multi-device routes record disk/write only.
    from nldsc_jax.ld.pipeline import STAGE_TIMES

    estimate_lds(prefix, ld_wind=10, wind_metric="kbp", maf_thr=0.01,
                 std_thr=1e-4, out=str(tmp_path / "one.L2"),
                 block_size=64, n_devices=1)
    assert {"disk_s", "transfer_s", "device_s",
            "write_s"} <= set(STAGE_TIMES), STAGE_TIMES
    assert all(v >= 0 for v in STAGE_TIMES.values())


def test_h2_pipeline_files(toy_bfile, tmp_path):
    from nldsc_jax.ld.pipeline import estimate_lds
    from nldsc_jax.h2.pipeline import estimate_h2

    prefix, g, bp, rng = toy_bfile
    out = str(tmp_path / "scores.L2")
    estimate_lds(prefix, ld_wind=10, wind_metric="kbp", maf_thr=0.01,
                 std_thr=1e-4, out=out, extra=True, block_size=64)

    df = pd.read_csv(out, sep="\t").dropna()
    m = len(df)
    z = rng.normal(0, 1.2, size=m)
    ss = pd.DataFrame({"SNP": df["SNP"], "Z": z, "N": 10000.0})
    ss_path = str(tmp_path / "toy.sumstats")
    ss.to_csv(ss_path, sep="\t", index=False)

    json_path = str(tmp_path / "h2.json")
    summary = estimate_h2(ss_path, out, n_blocks=25, save_to_json=json_path)
    assert "additive" in summary and "dominant" in summary
    saved = json.loads(open(json_path).read())
    assert saved["additive"]["hsq"] == pytest.approx(summary["additive"]["hsq"])
    # refuses overwrite (reference attempt_save semantics)
    with pytest.raises(FileExistsError):
        estimate_h2(ss_path, out, n_blocks=25, save_to_json=json_path)


def test_cli_ld_and_h2(toy_bfile, tmp_path, rng):
    from utils import run_cli

    prefix, *_ = toy_bfile
    out = str(tmp_path / "cli.L2")
    res = run_cli(["ld", "--bfile", prefix, "-kb", "10",
                               "-maf", "0.01", "--extra", "-o", out,
                               "--block-size", "64", "--display"])
    assert res.exit_code == 0, res.output
    df = pd.read_csv(out, sep="\t")
    assert "WSDE" in df.columns

    zdf = df.dropna()
    ss = pd.DataFrame({"SNP": zdf["SNP"],
                       "Z": np.random.default_rng(1).normal(size=len(zdf)),
                       "N": 5000.0})
    ss_path = str(tmp_path / "cli.sumstats")
    ss.to_csv(ss_path, sep="\t", index=False)
    res = run_cli(["h2", "--sumstats", ss_path, "--ref-ld", out,
                               "--w-ld", out, "--n-blocks", "20", "--display"])
    assert res.exit_code == 0, res.output
    assert "h2 summary" in res.output

    # a DIFFERENT --w-ld path now works in the add+dom path (the reference
    # rejects it — nldsc/__main__.py:143-145; VERDICT r2 item 7): weights
    # come from the w-ld file wherever the reference used its own scores
    import shutil
    wld = str(tmp_path / "weights.L2")
    shutil.copy(out, wld)
    res = run_cli(["h2", "--sumstats", ss_path, "--ref-ld", out,
                               "--w-ld", wld, "--n-blocks", "20",
                               "--display"])
    assert res.exit_code == 0, res.output
    assert "h2 summary" in res.output

    # a nonexistent w-ld path still fails cleanly
    res = run_cli(["h2", "--sumstats", ss_path, "--ref-ld", out,
                               "--w-ld", "other"])
    assert res.exit_code != 0


def test_cli_options_match_signatures():
    # structural gate: a command that reads an option the parser does not
    # define crashes EVERY invocation of that command (round-2 regression:
    # the --shard-axis option shipped without its use).  Invoking every
    # command per flag combination is too slow, so check the wiring
    # itself: every ``args.<name>`` a command function reads is a
    # destination of that command's parser.
    import argparse
    import inspect
    import re

    from nldsc_jax import cli

    parser = cli.build_parser()
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    assert set(sub.choices) == {"ld", "ld-genome", "h2", "convert"}
    for name, p in sub.choices.items():
        func = p.get_default("func")
        dests = {a.dest for a in p._actions} | {"func"}
        used = set(re.findall(r"args\.(\w+)", inspect.getsource(func)))
        if func in (cli.est_ld, cli.est_ld_genome):
            used |= set(re.findall(r"args\.(\w+)",
                                   inspect.getsource(cli._window)))
        assert used <= dests, (name, sorted(used - dests))


def test_cli_shard_axis_samples(toy_bfile, tmp_path):
    # --shard-axis samples must route through the sample-sharded engine
    # and match the default engine's output
    from utils import run_cli

    prefix, *_ = toy_bfile
    out_def = str(tmp_path / "def.L2")
    out_smp = str(tmp_path / "smp.L2")
    base_args = ["ld", "--bfile", prefix, "-kb", "10", "-maf", "0.01",
                 "--block-size", "64", "--display"]
    res = run_cli([*base_args, "-o", out_def])
    assert res.exit_code == 0, res.output
    res = run_cli([*base_args, "-o", out_smp,
                               "--shard-axis", "samples", "--n-devices", "4"])
    assert res.exit_code == 0, res.output
    a = pd.read_csv(out_def, sep="\t")
    b = pd.read_csv(out_smp, sep="\t")
    for col in ("L2", "L2D"):
        np.testing.assert_allclose(b[col], a[col], rtol=1e-4, atol=1e-4,
                                   equal_nan=True)


def test_cli_shard_axis_grid(toy_bfile, tmp_path):
    # --shard-axis grid routes the in-core 2-D (snp x samp) mesh engine
    # (and with --streaming, the chunk-ring of sample submeshes); both
    # must match the default engine's output
    from utils import run_cli

    prefix, *_ = toy_bfile
    out_def = str(tmp_path / "gdef.L2")
    out_grid = str(tmp_path / "grid.L2")
    out_gs = str(tmp_path / "gstream.L2")
    base_args = ["ld", "--bfile", prefix, "-kb", "10", "-maf", "0.01",
                 "--block-size", "64", "--display"]
    res = run_cli([*base_args, "-o", out_def])
    assert res.exit_code == 0, res.output
    res = run_cli([*base_args, "-o", out_grid,
                               "--shard-axis", "grid", "--n-devices", "4"])
    assert res.exit_code == 0, res.output
    res = run_cli([*base_args, "-o", out_gs, "--streaming",
                               "--chunk-rows", "128",
                               "--shard-axis", "grid", "--n-devices", "4"])
    assert res.exit_code == 0, res.output
    a = pd.read_csv(out_def, sep="\t")
    for path in (out_grid, out_gs):
        b = pd.read_csv(path, sep="\t")
        for col in ("L2", "L2D"):
            np.testing.assert_allclose(b[col], a[col], rtol=1e-4, atol=1e-4,
                                       equal_nan=True)


def test_cli_requires_one_window(toy_bfile):
    from utils import run_cli

    prefix, *_ = toy_bfile
    res = run_cli(["ld", "--bfile", prefix])
    assert res.exit_code != 0
    res = run_cli(["ld", "--bfile", prefix, "-kb", "5", "-cm", "1"])
    assert res.exit_code != 0


def test_cli_engine_flags(tmp_path, rng):
    # lock the new engine-selection surface: every flag combination
    # produces oracle-parity output through the CLI
    import pandas as pd
    from utils import run_cli
    from nldsc_jax.io.plink import write_plink
    from utils import make_positions, random_genotypes

    m, n = 150, 120
    g = random_genotypes(rng, m, n, missing_rate=0.03)
    pos = make_positions(m, spacing=700, jitter_rng=rng)
    prefix = write_plink(tmp_path / "flags", g, bp=pos.astype(np.int64))

    outs = {}
    for name, flags in {
        "default": [],
        "f32": ["--engine", "f32"],
        "nosym": ["--no-symmetric"],
        "bf16": ["--dot-dtype", "bf16"],
        "f32-nosym": ["--engine", "f32", "--no-symmetric"],
    }.items():
        out = str(tmp_path / f"{name}.L2")
        res = run_cli([
            "ld", "--bfile", prefix, "-kb", "40", "-maf", "0.01",
            "--block-size", "32", "-o", out, *flags])
        assert res.exit_code == 0, res.output
        outs[name] = pd.read_csv(out, sep="\t")

    base = outs.pop("default")
    for name, df in outs.items():
        for col in ("L2", "L2D"):
            np.testing.assert_allclose(
                df[col], base[col], rtol=1e-4, atol=1e-4,
                equal_nan=True, err_msg=f"{name}:{col}")


def test_cli_ld_genome(tmp_path, rng):
    """ld-genome: many single-chromosome bfiles -> one .L2 each, matching
    per-file `ld` runs; glob and comma-list inputs."""
    from utils import run_cli
    from nldsc_jax.io.plink import write_plink
    from nldsc_jax.ld.pipeline import estimate_lds

    prefixes = []
    for chrom in (20, 21):
        m = 120
        g = random_genotypes(rng, m, 90, missing_rate=0.02)
        bp = make_positions(m, spacing=700).astype(np.int64)
        p = str(tmp_path / f"chr{chrom}")
        write_plink(p, g, bp=bp, chrom=chrom)
        prefixes.append(p)

    out_dir = str(tmp_path / "out")
    res = run_cli(["ld-genome", "--bfiles",
                               str(tmp_path / "chr2*"), "--out-dir", out_dir,
                               "-kb", "30", "-maf", "0.01", "--display"])
    assert res.exit_code == 0, res.output
    for p in prefixes:
        import os
        out = os.path.join(out_dir, os.path.basename(p) + ".L2")
        got = pd.read_csv(out, sep="\t")
        ref = estimate_lds(p, ld_wind=30, wind_metric="kbp", maf_thr=0.01)
        np.testing.assert_allclose(got["L2"], ref["L2"].round(5),
                                   atol=1e-5, equal_nan=True)

    # comma list form + window-option validation + per-chromosome
    # sharding flags forwarded
    res = run_cli(["ld-genome", "--bfiles",
                               ",".join(prefixes), "--out-dir",
                               str(tmp_path / "out2"), "-kb", "30",
                               "-maf", "0.01", "--display",
                               "--shard-axis", "grid", "--n-devices", "4"])
    assert res.exit_code == 0, res.output
    res = run_cli(["ld-genome", "--bfiles", prefixes[0],
                               "--out-dir", out_dir])
    assert res.exit_code != 0

    # a glob matching nothing must fail up front (handle_exception logs
    # the "No bfiles match" reason to the stderr logger and exits 1 —
    # CliRunner can't see that stream, so assert the exit + no outputs)
    out3 = str(tmp_path / "out3")
    res = run_cli(["ld-genome", "--bfiles",
                               str(tmp_path / "nope*"), "--out-dir",
                               out3, "-kb", "30"])
    import os
    assert res.exit_code != 0 and not os.path.isdir(out3)

    # ... and identical basenames in different dirs must refuse rather
    # than silently overwrite outputs (exits before writing anything)
    sub = tmp_path / "b2"
    sub.mkdir()
    import shutil
    for ext in (".bed", ".bim", ".fam"):
        shutil.copy(prefixes[0] + ext, str(sub / ("chr20" + ext)))
    res = run_cli(["ld-genome", "--bfiles",
                               f"{prefixes[0]},{sub / 'chr20'}",
                               "--out-dir", out3, "-kb", "30"])
    assert res.exit_code != 0 and not os.path.isdir(out3)

    # genome-wide --annot (SNPs of BOTH chromosomes in one file; absent
    # ones zero-fill) + per-chromosome --resume-dir checkpoints
    bim = pd.read_csv(prefixes[0] + ".bim", sep="\t", header=None)
    snps = list(bim[1])
    annot_path = str(tmp_path / "genome.annot")
    pd.DataFrame({"SNP": snps,
                  "CAT": rng.integers(0, 2, len(snps))}).to_csv(
        annot_path, sep="\t", index=False)
    out4 = str(tmp_path / "out4")
    ck = str(tmp_path / "ck")
    res = run_cli(["ld-genome", "--bfiles",
                               ",".join(prefixes), "--out-dir", out4,
                               "-kb", "30", "-maf", "0.01", "--display",
                               "--annot", annot_path, "--streaming",
                               "--chunk-rows", "64", "--resume-dir", ck])
    assert res.exit_code == 0, res.output
    for p in prefixes:
        got = pd.read_csv(os.path.join(out4, os.path.basename(p) + ".L2"),
                          sep="\t")
        assert "CAT.L2" in got.columns
        assert os.path.isdir(os.path.join(ck, os.path.basename(p)))
