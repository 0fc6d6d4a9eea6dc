"""Single-process coverage of the multi-host scaffolding."""

import numpy as np

import jax

from nldsc_jax.parallel import distributed as dist
from nldsc_jax.parallel.mesh import snp_mesh

from utils import make_positions, random_genotypes


def test_assign_chromosomes_single_process():
    files = [f"chr{i}" for i in range(1, 23)]
    assert dist.assign_chromosomes(files) == files  # 1 process owns all


def test_shard_rows_for_process():
    mesh = snp_mesh(8)
    start, stop = dist.shard_rows_for_process(800, mesh)
    assert (start, stop) == (0, 800)  # single process owns every device


def test_make_global_genotypes_roundtrip(rng):
    mesh = snp_mesh(8)
    g = random_genotypes(rng, 160, 64)
    arr = dist.make_global_genotypes(g, 160, mesh)
    assert arr.shape == (160, 64)
    np.testing.assert_array_equal(np.asarray(arr), g)
    # sharded over the snp axis
    assert len(arr.sharding.device_set) == 8


def test_mesh_level_end_to_end_matches_dense(tmp_path, rng):
    """The full P4 path: per-device byte-range .bed ingestion -> global
    sharded assembly -> shard_map engine == the dense single-device result
    (each of the 8 virtual devices stands in for a host)."""
    from nldsc_jax.config import LDConfig
    from nldsc_jax.io.plink import write_plink
    from nldsc_jax.ld.pipeline import compute_ld_scores

    m, n = 300, 150
    g = random_genotypes(rng, m, n, missing_rate=0.03)
    pos = make_positions(m, spacing=700, jitter_rng=rng)
    prefix = write_plink(tmp_path / "mesh", g, bp=pos.astype(np.int64))

    mesh = snp_mesh(8)
    df = dist.estimate_lds_mesh(prefix, ld_wind=6, wind_metric="kbp",
                                maf_thr=0.01, std_thr=1e-4, block_size=16,
                                mesh=mesh, extra=True)

    cfg = LDConfig(ld_wind=6, wind_metric="kbp", maf_thr=0.01, std_thr=1e-4,
                   rsq_thr=None, block_size=16).resolve_rsq(m)
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg)
    np.testing.assert_allclose(df["L2"].to_numpy(), dense["l2"],
                               rtol=1e-5, atol=1e-5, equal_nan=True)
    np.testing.assert_allclose(df["L2D"].to_numpy(), dense["l2d"],
                               rtol=1e-5, atol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(df["WSA"].to_numpy(), dense["l2_ws"])
    np.testing.assert_array_equal(df["WSDE"].to_numpy(), dense["l2d_wse"])

    # writing through the same output machinery as estimate_lds
    out = str(tmp_path / "mesh.L2")
    dist.estimate_lds_mesh(prefix, ld_wind=6, wind_metric="kbp",
                           maf_thr=0.01, std_thr=1e-4, block_size=16,
                           mesh=mesh, out=out)
    import os
    assert os.path.exists(out) and os.path.exists(str(tmp_path / "mesh.M"))


def test_mesh_level_annot_matches_dense(tmp_path, rng):
    """Partitioned LD through the mesh-level multi-host driver (r4):
    annot rows assemble/shard like the genotype rows."""
    import pandas as pd

    from nldsc_jax.config import LDConfig
    from nldsc_jax.io.plink import write_plink
    from nldsc_jax.ld.pipeline import compute_ld_scores

    m, n = 256, 128
    g = random_genotypes(rng, m, n, missing_rate=0.02)
    pos = make_positions(m, spacing=700)
    prefix = write_plink(tmp_path / "ma", g, bp=pos.astype(np.int64))
    bim = pd.read_csv(prefix + ".bim", sep="\t", header=None)
    annot = np.column_stack([np.ones(m),
                             (rng.random(m) < 0.4).astype(np.float64)])
    annot_path = str(tmp_path / "ma.annot")
    pd.DataFrame({"SNP": bim[1], "base": annot[:, 0],
                  "cat": annot[:, 1]}).to_csv(annot_path, sep="\t",
                                              index=False)

    mesh = snp_mesh(8)
    df = dist.estimate_lds_mesh(prefix, ld_wind=6, wind_metric="kbp",
                                maf_thr=0.01, std_thr=1e-4, block_size=16,
                                mesh=mesh, annot=annot_path)
    cfg = LDConfig(ld_wind=6, wind_metric="kbp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=None, block_size=16).resolve_rsq(m)
    dense = compute_ld_scores(g, pos.astype(np.float64), cfg, annot=annot)
    np.testing.assert_allclose(df["base.L2"].to_numpy(),
                               dense["l2_annot"][:, 0], rtol=1e-5,
                               atol=1e-4, equal_nan=True)
    np.testing.assert_allclose(df["cat.L2D"].to_numpy(),
                               dense["l2d_annot"][:, 1], rtol=1e-5,
                               atol=1e-4, equal_nan=True)


def test_multihost_driver_runs_locally(tmp_path, rng):
    from nldsc_jax.io.plink import write_plink

    prefixes = []
    for chrom in (21, 22):
        g = random_genotypes(rng, 64, 40)
        p = write_plink(tmp_path / f"chr{chrom}", g, chrom=chrom)
        prefixes.append(p)
    outs = dist.estimate_lds_multihost(
        prefixes, out_template=str(tmp_path / "{stem}.L2"),
        ld_wind=10, wind_metric="kbp", maf_thr=0.01, block_size=16,
        extra=True)
    assert len(outs) == 2
    import pandas as pd

    for o in outs:
        df = pd.read_csv(o, sep="\t")
        assert len(df) == 64
