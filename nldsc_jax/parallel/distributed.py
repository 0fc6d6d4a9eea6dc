"""Multi-host scaffolding: jax.distributed + per-host shard ingestion.

Two scale-out modes (SURVEY §2.2 plan):

1. **Job-level (recommended, DCN-free)** — chromosomes round-robined over
   hosts with :func:`assign_chromosomes`; each host runs its chromosomes on
   its local chips (single-chromosome runs are embarrassingly parallel,
   matching the reference's one-chromosome-per-file model).

2. **Mesh-level (one huge chromosome across hosts)** — a global 1-D SNP
   mesh spanning all processes: each host block-decodes only its own byte
   range of the SNP-major `.bed` (a SNP range IS a contiguous byte range),
   assembles the global sharded array with
   ``jax.make_array_from_process_local_data``, and the sharded engine's
   halo ``ppermute``s ride ICI within a slice / DCN across slices.

This module is exercised single-process in CI (process_count == 1); the
multi-process paths use only public, stable JAX APIs.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.logging import log
from .mesh import SNP_AXIS, snp_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the multi-host runtime (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    log.info("distributed: process %d/%d, %d local / %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())


def assign_chromosomes(bfiles: list[str]) -> list[str]:
    """Round-robin chromosome files over hosts (job-level scale-out)."""
    pid, n = jax.process_index(), jax.process_count()
    return [b for i, b in enumerate(bfiles) if i % n == pid]


def global_snp_mesh():
    """1-D SNP mesh over ALL devices of all processes."""
    return snp_mesh(devices=jax.devices())


def shard_rows_for_process(m_pad: int, mesh) -> tuple[int, int]:
    """Global row range [start, stop) owned by this process on ``mesh``.

    Rows are laid out contiguously per device in mesh order, so a process's
    rows are the union of its addressable devices' rows — contiguous for a
    standard mesh ordering.
    """
    devices = list(mesh.devices.flat)
    per_dev = m_pad // len(devices)
    mine = [i for i, d in enumerate(devices)
            if d.process_index == jax.process_index()]
    return min(mine) * per_dev, (max(mine) + 1) * per_dev


def make_global_genotypes(local_rows: np.ndarray, m_pad: int, mesh):
    """Assemble the globally-sharded int8 genotype array from this host's
    locally-decoded row range (mesh-level mode)."""
    sharding = NamedSharding(mesh, P(SNP_AXIS))
    return jax.make_array_from_process_local_data(sharding, local_rows,
                                                  (m_pad,) + local_rows.shape[1:])


def device_row_ranges(m_pad: int, mesh):
    """Per-device contiguous global row ranges ``(r0, r1, device)``."""
    devices = list(mesh.devices.flat)
    per = m_pad // len(devices)
    return [(i * per, (i + 1) * per, d) for i, d in enumerate(devices)]


def estimate_lds_mesh(bfile: str, ld_wind: float, wind_metric: str,
                      maf_thr: float = 1e-5, std_thr: float = 1e-5,
                      rsq_thr: float | None = None, *, out: str | None = None,
                      extra: bool = False, block_size: int = 512,
                      mesh=None, write_m: bool = True,
                      annot: str | None = None):
    """Mesh-level driver: ONE chromosome sharded across all hosts/devices.

    The end-to-end P4 path: each participant byte-range-decodes only its
    own SNP rows of the .bed (``BedReader.read_block`` — a SNP range is a
    contiguous byte range in the SNP-major layout), the global sharded
    array is assembled without any host ever holding the full matrix, and
    the shard_map engine's halo ppermutes ride ICI/DCN.

    Multi-process: each process ingests its :func:`shard_rows_for_process`
    range (``jax.make_array_from_process_local_data``).  Single-process:
    each *device* is treated as an ingestion unit (per-device byte-range
    reads + ``make_array_from_single_device_arrays``) — the same assembly
    path CI exercises on the 8-virtual-device harness.

    Returns the result DataFrame (or writes ``out`` like ``estimate_lds``).
    """
    from ..config import LDConfig
    from ..io.ldscores import make_output, write_l2, write_m_files
    from ..io.plink import PlinkDataset
    from .sharded import ld_scores_sharded_global, sharded_geometry

    ds = PlinkDataset.parse(bfile)
    m, n = ds.n_snp, ds.n_samples
    config = LDConfig(
        ld_wind=ld_wind, wind_metric=wind_metric, maf_thr=maf_thr,
        std_thr=std_thr, rsq_thr=rsq_thr, block_size=block_size,
    ).resolve_rsq(m)
    positions = ds.positions(config.wind_metric)
    if mesh is None:
        mesh = global_snp_mesh()
    m_pad, n_pad, _, _ = sharded_geometry(m, n, positions, config, mesh)

    def read_rows(r0: int, r1: int) -> np.ndarray:
        """Byte-range PACKED read of global rows [r0, r1): raw 2-bit .bed
        bytes (4× less host→device/DCN traffic than int8 codes); padding
        rows are 0x55 (all-missing → code −1 after device unpack)."""
        buf = np.full((r1 - r0, ds.bed.bytes_per_snp), 0x55, dtype=np.uint8)
        s1 = min(r1, m)
        if s1 > r0:
            buf[:s1 - r0] = ds.bed.read_raw(r0, s1 - r0).raw
        return buf

    bps = ds.bed.bytes_per_snp
    sharding = NamedSharding(mesh, P(SNP_AXIS))
    if jax.process_count() > 1:
        start, stop = shard_rows_for_process(m_pad, mesh)
        log.info("mesh-level: process %d ingests rows [%d, %d)",
                 jax.process_index(), start, stop)
        raw_global = jax.make_array_from_process_local_data(
            sharding, read_rows(start, stop), (m_pad, bps))
    else:
        shards = [jax.device_put(read_rows(r0, r1), d)
                  for r0, r1, d in device_row_ranges(m_pad, mesh)]
        raw_global = jax.make_array_from_single_device_arrays(
            (m_pad, bps), sharding, shards)

    # unpack on device under the mesh: row-wise elementwise, so the SNP
    # sharding propagates and no resharding happens
    from ..ld.preprocess import unpack_bed
    with mesh:
        g_global = unpack_bed(raw_global, n_samples=n, n_pad=n_pad,
                              pad_val=-1)

    annot_global = annot_mat = annot_names = None
    if annot is not None:
        from ..io.ldscores import read_annot  # noqa: PLC0415

        annot_mat, annot_names = read_annot(annot, ds.bim)
        a_pad = np.zeros((m_pad, annot_mat.shape[1]), np.float32)
        a_pad[:m] = np.asarray(annot_mat, dtype=np.float32)
        if jax.process_count() > 1:
            start, stop = shard_rows_for_process(m_pad, mesh)
            annot_global = jax.make_array_from_process_local_data(
                sharding, np.ascontiguousarray(a_pad[start:stop]),
                (m_pad, a_pad.shape[1]))
        else:
            annot_global = jax.device_put(a_pad, sharding)

    result = ld_scores_sharded_global(g_global, positions, config, mesh,
                                      m, n, annot_global=annot_global)
    if annot is not None:
        from ..io.ldscores import (  # noqa: PLC0415
            make_output_annot, write_m_files_annot)

        out_df = make_output_annot(ds.bim, result, annot_names)
        if out:
            write_l2(out_df, out)
            if write_m:
                write_m_files_annot(result, annot_mat, annot_names, out)
            return None
        return out_df.to_pandas()
    out_df = make_output(ds.bim, result, extra=extra)
    if out:
        write_l2(out_df, out)
        if write_m:
            write_m_files(result, out)
        return None
    return out_df.to_pandas()


def estimate_lds_multihost(bfiles: list[str], out_template: str = "{stem}.L2",
                           **kwargs) -> list[str]:
    """Job-level multi-host driver: run this host's chromosomes locally.

    ``bfiles``: all chromosome bfile prefixes (identical list on every
    host). Returns the output paths this host produced.
    """
    from pathlib import Path

    from ..ld.pipeline import estimate_lds

    outs = []
    for bfile in assign_chromosomes(bfiles):
        stem = Path(bfile).stem
        out = out_template.format(stem=stem)
        log.info("host %d: chromosome %s -> %s", jax.process_index(),
                 bfile, out)
        estimate_lds(bfile, out=out, **kwargs)
        outs.append(out)
    return outs
