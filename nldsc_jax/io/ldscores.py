"""Reading/writing .L2 score tables and .M / .M_5_50 sidecars.

Output contract (SURVEY §2.4): tab-separated, ``%.5f`` floats, columns
``CHR SNP BP L2 L2D`` plus ``MAF WSA WSD WSDE RSTD`` with ``--extra``
(reference ``nldsc/ldscore/routine.py:32-48,97-100``).

Unlike the reference — which *promises* a .M file but never writes one
(SURVEY Q8) — we write both ``.M`` (all usable SNPs) and ``.M_5_50``
(usable SNPs with MAF > 5%, the standard LDSC convention).  ``MD`` uses the
reference's de-facto estimator ``M * mean(WSDE / WSA)``
(``nldsc/h2/common.py:128-131``) restricted to the same SNP set.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.logging import log
from .table import Table, first_unique, read_table, sort_rows, write_table

L2_COLUMNS = ["CHR", "SNP", "BP", "L2", "L2D"]
EXTRA_COLUMNS = ["MAF", "WSA", "WSD", "WSDE", "RSTD"]


def make_output(bim: Table, result: dict, extra: bool = False) -> Table:
    """Assemble the .L2 table (reference make_output, routine.py:32-48)."""
    data = {
        "CHR": bim["CHR"],
        "SNP": bim["SNP"],
        "BP": bim["BP"],
        "L2": result["l2"],
        "L2D": result["l2d"],
    }
    if extra:
        data["MAF"] = result["maf"]
        data["WSA"] = result["l2_ws"]
        data["WSD"] = result["l2d_ws"]
        data["WSDE"] = result["l2d_wse"]
        data["RSTD"] = result["residuals_std"]
    return Table(data)


def write_l2(table: Table, out: str) -> None:
    write_table(table, out, float_format="%.5f")
    log.info("Wrote LD scores: %s", out)


def m_counts(result: dict, maf_floor: float | None = None) -> tuple[int, int]:
    """(M, MD) over usable SNPs, optionally restricted to MAF > maf_floor."""
    l2 = np.asarray(result["l2"], dtype=np.float64)
    maf = np.asarray(result["maf"], dtype=np.float64)
    wsa = np.asarray(result["l2_ws"], dtype=np.float64)
    wsde = np.asarray(result["l2d_wse"], dtype=np.float64)
    sel = ~np.isnan(l2)
    if maf_floor is not None:
        sel &= maf > maf_floor
    m = int(sel.sum())
    if m == 0:
        return 0, 0
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = wsde[sel] / wsa[sel]
    md = m * float(np.nanmean(ratio)) if np.isfinite(ratio).any() else 0.0
    return m, int(md)


def write_m_files(result: dict, l2_path: str) -> None:
    """Write .M and .M_5_50 siblings of the .L2 file (fixes quirk Q8).

    Uses ``with_suffix`` naming so the h2 reader's sidecar resolution
    (``path.with_suffix('.M')``, reference common.py:119-127) finds them.
    """
    base = Path(l2_path)
    for suffix, floor in ((".M", None), (".M_5_50", 0.05)):
        m, md = m_counts(result, floor)
        write_table(Table({"M": [m], "MD": [md]}), base.with_suffix(suffix))
    log.info("Wrote SNP counts: %s / %s",
             base.with_suffix(".M"), base.with_suffix(".M_5_50"))


def read_m(path: str) -> tuple[int, int]:
    m = read_table(path, sep="\t")
    return int(m["M"][0]), int(m["MD"][0])


def _has_na(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype == object:
        return np.array([v is None for v in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)


def read_l2_file(path: str) -> Table:
    """One .L2 table, sorted by CHR,BP (SEs depend on it — common.py:137),
    without rows that have a missing value or a repeated SNP."""
    score = sort_rows(read_table(path, sep="\t", text_columns=("SNP",)),
                      ["CHR", "BP"])
    na = np.zeros(len(score), dtype=bool)
    for c in score.columns:
        na |= _has_na(score[c])
    score = score.take(~na)
    return score.take(first_unique(score["SNP"]))


def _concat(tables: list[Table]) -> Table:
    return Table({c: np.concatenate([t[c] for t in tables])
                  for c in tables[0].columns})


def read_ld_scores(path: str, use_m: bool = False) -> tuple[Table, int, int]:
    """File-or-directory LD score reader (reference LDScoreReader).

    Returns (scores, M, MD).  M/MD resolution per reference
    ``nldsc/h2/common.py:119-131``: prefer the requested sidecar
    (.M with ``use_m`` else .M_5_50, falling back to .M), else derive
    ``M = #rows``, ``MD = M * mean(WSDE/WSA)`` — which requires the
    ``--extra`` columns in the .L2 file.
    """
    p = Path(path)
    if p.is_dir():
        frames, m_tot, md_tot = [], 0, 0
        files = sorted(p.glob("*.L2"))
        if not files:
            raise FileNotFoundError(f"no *.L2 files in directory {path}")
        for f in files:
            score, m, md = _read_one(f, use_m)
            frames.append(score[L2_COLUMNS])
            m_tot += m
            md_tot += md
        scores = sort_rows(_concat(frames), ["CHR", "BP"])
        return scores, m_tot, md_tot
    return _read_one(p, use_m)


def read_annot(path: str, bim) -> tuple[np.ndarray, list[str]]:
    """Read a per-SNP annotation file for partitioned LD computation.

    Whitespace/tab-separated with a ``SNP`` column plus one column per
    annotation (continuous values allowed; ``CHR``/``BP``/``CM``/``A1``/
    ``A2`` key columns are ignored) — the ldsc ``.annot`` convention.
    Rows are aligned to the bim's SNP order; SNPs absent from the file get
    all-zero annotation rows (they still contribute nothing to any
    category but receive scores from annotated neighbors).

    ``bim`` is any table with a ``SNP`` column.

    Returns (annot float64 (M, p), annotation names).
    """
    tab = read_table(path, text_columns=("SNP",))
    if "SNP" not in tab.columns:
        raise ValueError(f"annotation file {path} needs a SNP column")
    names = [c for c in tab.columns
             if c not in {"CHR", "BP", "CM", "SNP", "A1", "A2"}]
    if not names:
        raise ValueError(f"annotation file {path} has no annotation columns")
    tab = tab.take(first_unique(tab["SNP"]))
    row_of = {s: i for i, s in enumerate(tab["SNP"].tolist())}
    snps = np.asarray(bim["SNP"]).tolist()
    idx = np.array([row_of.get(s, -1) for s in snps], dtype=np.int64)
    found = idx >= 0
    vals = np.zeros((len(snps), len(names)), dtype=np.float64)
    for k, name in enumerate(names):
        vals[found, k] = np.asarray(tab[name], dtype=np.float64)[idx[found]]
    n_missing = int((~found).sum())
    if n_missing:
        log.warning("%d of %d bim SNPs absent from %s; their annotation "
                    "rows are set to 0", n_missing, len(snps), path)
    return np.nan_to_num(vals, nan=0.0), names


def make_output_annot(bim: Table, result: dict, names: list[str]) -> Table:
    """Assemble a partitioned .L2 table: per-annotation additive
    (``<name>.L2``) and dominance (``<name>.L2D``) score columns."""
    data = {"CHR": bim["CHR"], "SNP": bim["SNP"], "BP": bim["BP"]}
    for k, name in enumerate(names):
        data[f"{name}.L2"] = result["l2_annot"][:, k]
    for k, name in enumerate(names):
        data[f"{name}.L2D"] = result["l2d_annot"][:, k]
    return Table(data)


def write_m_files_annot(result: dict, annot: np.ndarray, names: list[str],
                        l2_path: str) -> None:
    """Per-annotation .M / .M_5_50 sidecars (columns named ``<name>.L2``
    to match the partitioned .L2's annotation columns).

    Follows the LDSC convention M_k = Σ_i annot[i, k] over usable SNPs
    (all, and MAF > 5% for .M_5_50)."""
    base = Path(l2_path)
    l2 = np.asarray(result["l2"], dtype=np.float64)
    maf = np.asarray(result["maf"], dtype=np.float64)
    usable = ~np.isnan(l2)
    for suffix, floor in ((".M", None), (".M_5_50", 0.05)):
        sel = usable if floor is None else usable & (maf > floor)
        counts = annot[sel].sum(axis=0)
        write_table(Table({f"{n}.L2": [c] for n, c in zip(names, counts)}),
                    base.with_suffix(suffix))
    log.info("Wrote per-annotation SNP counts: %s / %s",
             base.with_suffix(".M"), base.with_suffix(".M_5_50"))


# columns of a .L2 table that are never annotations
_NON_ANNOT = {"CHR", "SNP", "BP", "CM", "L2D", *EXTRA_COLUMNS}


def annotation_columns(score: Table) -> list[str]:
    """Annotation (per-category LD score) columns of a partitioned .L2
    table: every column that is not a key/extra column (per-annotation
    dominance columns ``*.L2D`` are carried but are not regression
    annotations).  A plain single-annotation file yields ``["L2"]``."""
    annots = [c for c in score.columns
              if c not in _NON_ANNOT and not c.endswith(".L2D")]
    if not annots:
        raise ValueError("no LD-score annotation columns found "
                         "(expected `L2` or per-annotation columns)")
    return annots


def read_m_partitioned(path: str, annots: list[str]) -> np.ndarray:
    """Read a (1, p) SNP-count row for partitioned scores.

    Accepts either our headered TSV (columns matching the annotation
    names, or the legacy ``M``/``MD`` pair) or a headerless
    whitespace-separated row of p numbers (ldsc's ``.l2.M_5_50`` style).
    """
    with open(path) as f:
        first = f.readline().split()
    try:
        vals = np.array([float(v) for v in first], dtype=np.float64)
    except ValueError:
        vals = None
    if vals is not None:
        if vals.size != len(annots):
            raise ValueError(
                f"M file {path} has {vals.size} counts but the .L2 has "
                f"{len(annots)} annotation columns")
        return vals.reshape(1, -1)
    tab = read_table(path)
    if len(annots) == 1 and "M" in tab.columns:
        # legacy single-annotation sidecar (columns M, MD)
        return np.array([[tab["M"][0]]], dtype=np.float64)
    missing = [a for a in annots if a not in tab.columns]
    if missing:
        raise ValueError(f"M file {path} lacks counts for annotations "
                         f"{missing}")
    return np.array([[tab[a][0] for a in annots]], dtype=np.float64)


def read_ld_scores_partitioned(
    path: str, use_m: bool = False,
) -> tuple[Table, np.ndarray, list[str]]:
    """File-or-directory reader for partitioned (multi-annotation) LD
    scores — the capability the reference declares but never implements
    (SURVEY Q12).

    Returns ``(scores, M_annot, annot_names)`` where ``scores`` has
    columns ``SNP`` + one LD-score column per annotation and ``M_annot``
    is the (1, p) per-annotation SNP-count row summed across files.
    """
    p = Path(path)
    files = sorted(p.glob("*.L2")) if p.is_dir() else [p]
    if not files:
        raise FileNotFoundError(f"no *.L2 files in directory {path}")
    frames, m_tot, annots = [], None, None
    for f in files:
        score = read_l2_file(str(f))
        cur = annotation_columns(score)
        if annots is None:
            annots = cur
        elif cur != annots:
            raise ValueError(
                f"annotation columns differ across files: {annots} vs "
                f"{cur} in {f}")
        suffix = ".M" if use_m else ".M_5_50"
        sidecar = f.with_suffix(suffix)
        if not sidecar.exists() and not use_m:
            sidecar = f.with_suffix(".M")
        if sidecar.exists():
            m = read_m_partitioned(str(sidecar), annots)
        elif annots == ["L2"]:
            m = np.array([[len(score)]], dtype=np.float64)
        else:
            raise ValueError(
                f"no .M/.M_5_50 sidecar for partitioned file {f}; "
                "per-annotation SNP counts cannot be derived from rows")
        frames.append(score[["SNP", "CHR", "BP", *annots]])
        m_tot = m if m_tot is None else m_tot + m
    return sort_rows(_concat(frames), ["CHR", "BP"]), m_tot, annots


def _read_one(path: Path, use_m: bool) -> tuple[Table, int, int]:
    suffix = ".M" if use_m else ".M_5_50"
    sidecar = path.with_suffix(suffix)
    if not sidecar.exists() and not use_m:
        sidecar = path.with_suffix(".M")
    score = read_l2_file(str(path))
    if sidecar.exists():
        m, md = read_m(str(sidecar))
    else:
        if "WSDE" not in score.columns or "WSA" not in score.columns:
            raise ValueError(
                f"no .M/.M_5_50 sidecar for {path} and the .L2 lacks the "
                "--extra columns needed for the M/MD fallback"
            )
        m = len(score["L2"])
        with np.errstate(invalid="ignore", divide="ignore"):
            md = int(m * np.nanmean(score["WSDE"] / score["WSA"]))
    return score, m, int(md)
