"""CPU end-to-end genome→h2 loop: ld-genome over several chromosomes,
then h2 (two-stg / one-stg / partitioned) on the produced directory —
the full product loop (scripts/time_genome.py runs the same shape at
scale on hardware).  Reference usage anchor: per-chromosome ld runs,
then h2 over the collected scores (nldsc README)."""

import json
import os

import numpy as np
import pandas as pd
import pytest

from nldsc_jax.io.plink import write_plink

from utils import random_genotypes, run_cli


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    td = tmp_path_factory.mktemp("genome")
    rng = np.random.default_rng(9)
    n = 256
    snp_rows = []
    total_m = 0
    for c in range(1, 5):
        m = 240 + 60 * (c % 2)
        g = random_genotypes(rng, m, n, missing_rate=0.0)
        if c == 2:  # one chromosome with row-missing
            for i in rng.choice(m, size=6, replace=False):
                mask = rng.random(n) < 0.1
                g[i] = np.where(mask, np.int8(-1), g[i])
        bp = np.arange(1, m + 1, dtype=np.int64) * 500
        names = [f"c{c}_rs{i}" for i in range(m)]
        bim = pd.DataFrame({"CHR": np.full(m, c), "SNP": names,
                            "CM": bp * 1e-6, "BP": bp,
                            "A1": "A", "A2": "G"})
        write_plink(td / f"chr{c:02d}", g, bim=bim)
        snp_rows.append(pd.DataFrame(
            {"SNP": names, "Z": rng.normal(size=m), "N": 10000.0}))
        total_m += m
    ss_path = td / "trait.sumstats"
    pd.concat(snp_rows).to_csv(ss_path, sep="\t", index=False)
    return td, ss_path, total_m


def test_ld_genome_then_h2(genome, tmp_path):
    td, ss_path, total_m = genome
    out_dir = str(tmp_path / "scores")
    res = run_cli([
        "ld-genome", "--bfiles", f"{td}/chr*.bed", "--out-dir", out_dir,
        "-kb", "50", "-maf", "0.01", "--extra", "--display"])
    assert res.exit_code == 0, res.output
    l2s = sorted(os.listdir(out_dir))
    assert [f for f in l2s if f.endswith(".L2")] == [
        "chr01.L2", "chr02.L2", "chr03.L2", "chr04.L2"]
    assert "chr01.M_5_50" in l2s

    # directory reader aggregates all chromosomes; rows must match
    rows = sum(sum(1 for _ in open(os.path.join(out_dir, f))) - 1
               for f in l2s if f.endswith(".L2"))
    assert rows == total_m

    for extra in ([], ["--strategy", "one-stg"], ["--on-device"]):
        out_json = str(tmp_path / f"h2_{len(extra)}.json")
        res = run_cli([
            "h2", "--sumstats", str(ss_path), "--ref-ld", out_dir,
            "--w-ld", out_dir, "-s", out_json, "--display", *extra])
        assert res.exit_code == 0, res.output
        with open(out_json) as f:
            summary = json.load(f)
        # null-noise Z: h2 near zero, lambda_GC near 1
        if "additive" in summary:
            assert abs(summary["additive"]["hsq"]) < 0.5
            assert 0.7 < summary["additive"]["lambda_gc"] < 1.3


def test_ld_genome_annot_then_partitioned_h2(genome, tmp_path):
    """Genome-wide PARTITIONED loop (r5, VERDICT r4 #5): ld-genome
    --annot over every chromosome into a directory, then h2
    --partitioned aggregating that directory (the directory reader,
    io/ldscores.py)."""
    td, ss_path, total_m = genome
    rng = np.random.default_rng(31)
    annot_rows = []
    for c in range(1, 5):
        m = 240 + 60 * (c % 2)
        annot_rows.append(pd.DataFrame({
            "SNP": [f"c{c}_rs{i}" for i in range(m)],
            "base": 1.0,
            "cat": (rng.random(m) < 0.3).astype(float)}))
    annot_path = str(tmp_path / "genome.annot")
    pd.concat(annot_rows).to_csv(annot_path, sep="\t", index=False)

    part_dir = str(tmp_path / "part")
    res = run_cli([
        "ld-genome", "--bfiles", f"{td}/chr*.bed", "--out-dir", part_dir,
        "-kb", "50", "-maf", "0.01", "--annot", annot_path, "--display"])
    assert res.exit_code == 0, res.output
    files = sorted(os.listdir(part_dir))
    assert [f for f in files if f.endswith(".L2")] == [
        "chr01.L2", "chr02.L2", "chr03.L2", "chr04.L2"]
    # per-annotation sidecars for every chromosome
    assert "chr01.M" in files and "chr04.M_5_50" in files
    # partitioned columns present
    with open(os.path.join(part_dir, "chr01.L2")) as f:
        header = f.readline().split()
    assert "base.L2" in header and "cat.L2" in header

    out_json = str(tmp_path / "h2_part.json")
    res = run_cli([
        "h2", "--sumstats", str(ss_path), "--ref-ld", part_dir,
        "--w-ld", part_dir, "--partitioned", "-s", out_json, "--display"])
    assert res.exit_code == 0, res.output
    with open(out_json) as f:
        summary = json.load(f)
    text = json.dumps(summary)
    assert "cat" in text and "base" in text, summary


def test_ld_genome_resume_dir(genome, tmp_path):
    """--resume-dir creates per-chromosome checkpoint roots (streaming)."""
    td, _, _ = genome
    out_dir = str(tmp_path / "scores")
    ck_dir = str(tmp_path / "ck")
    res = run_cli([
        "ld-genome", "--bfiles", f"{td}/chr01.bed,{td}/chr02.bed",
        "--out-dir", out_dir, "-kb", "50", "-maf", "0.01",
        "--streaming", "--chunk-rows", "128",
        "--resume-dir", ck_dir, "--display"])
    assert res.exit_code == 0, res.output
    assert sorted(os.listdir(ck_dir)) == ["chr01", "chr02"]
    assert any(f.startswith("chunk_") for f in
               os.listdir(os.path.join(ck_dir, "chr01")))
