"""LD-score format conversion (the reference's C20 stub, implemented).

The reference ships an EMPTY placeholder ``nldsc/misc/ld_converter.py``
(SURVEY C20: "an LD format converter was planned, never written").  Here
it is real: lossless round-trip between this package's ``.L2`` format and
the original ldsc toolchain's ``.l2.ldscore.gz`` / ``.l2.M`` /
``.l2.M_5_50`` files, so users can mix nldsc-jax LD scores with
`bulik/ldsc` munge/h2/rg pipelines and vice versa.

ldsc's conventions: ``<prefix>.l2.ldscore.gz`` is a tab-separated table
with columns ``CHR SNP BP L2``; ``<prefix>.l2.M`` and
``<prefix>.l2.M_5_50`` are single headerless whitespace-separated rows of
per-annotation SNP counts.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.logging import log
from .ldscores import read_m
from .table import Table, read_table, write_table

LDSC_COLS = ["CHR", "SNP", "BP", "L2"]


def to_ldsc(l2_path: str, out_prefix: str) -> None:
    """Convert a nldsc-jax ``.L2`` (+ ``.M``/``.M_5_50``) to ldsc files.

    Writes ``<out>.l2.ldscore.gz`` with the additive scores and, when the
    input carries dominance scores, ``<out>.d.l2.ldscore.gz`` with L2D in
    the L2 column (usable as a one-annotation partitioned score in ldsc).
    SNP counts go to headerless ``<out>.l2.M`` / ``<out>.l2.M_5_50``
    (and ``.d.l2.*`` twins using MD).
    """
    score = read_table(l2_path, sep="\t")
    missing = [c for c in ("CHR", "SNP", "BP", "L2") if c not in score.columns]
    if missing:
        raise ValueError(f"{l2_path} lacks required columns {missing}")
    out = Path(out_prefix)
    write_table(score[LDSC_COLS], f"{out}.l2.ldscore.gz", float_format="%.5f")
    m = md = None
    for suffix in (".M", ".M_5_50"):
        sidecar = Path(l2_path).with_suffix(suffix)
        if sidecar.exists():
            m, md = read_m(str(sidecar))
        elif m is None:
            m, md = len(score), 0
        with open(f"{out}.l2{suffix}", "w") as f:
            f.write(f"{m}\n")
        if "L2D" in score.columns:
            with open(f"{out}.d.l2{suffix}", "w") as f:
                f.write(f"{md}\n")
    if "L2D" in score.columns:
        dom = score[["CHR", "SNP", "BP", "L2D"]].rename({"L2D": "L2"})
        write_table(dom, f"{out}.d.l2.ldscore.gz", float_format="%.5f")
    log.info("Wrote ldsc-format scores: %s.l2.ldscore.gz", out)


def from_ldsc(prefix: str, out_l2: str) -> None:
    """Convert ldsc ``<prefix>.l2.ldscore[.gz]`` (+ ``.l2.M*``) to ``.L2``.

    ldsc has no dominance scores, so ``L2D`` is written as 0.0 — the
    additive h2 estimate on the converted file is exact; the dominance
    partition is degenerate (flagged in the log).
    """
    src = None
    for cand in (f"{prefix}.l2.ldscore.gz", f"{prefix}.l2.ldscore"):
        if Path(cand).exists():
            src = cand
            break
    if src is None:
        raise FileNotFoundError(f"no {prefix}.l2.ldscore[.gz]")
    score = read_table(src)
    missing = [c for c in LDSC_COLS if c not in score.columns]
    if missing:
        raise ValueError(f"{src} lacks required columns {missing}")
    df = score[LDSC_COLS]
    df["L2D"] = 0.0
    write_table(df, out_l2, float_format="%.5f")
    for suffix in (".M", ".M_5_50"):
        m_file = Path(f"{prefix}.l2{suffix}")
        if m_file.exists():
            counts = np.loadtxt(m_file, ndmin=1)
            m = int(counts.sum())
        else:
            m = len(df)
        write_table(Table({"M": [m], "MD": [0]}),
                    Path(out_l2).with_suffix(suffix))
    log.warning("ldsc scores carry no dominance component: L2D/MD set to "
                "0 in %s (additive h2 is exact; ignore the dominance "
                "partition)", out_l2)
