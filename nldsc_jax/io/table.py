"""Column tables for the text files the CLI reads and writes.

``.bim``/``.fam``, ``.L2``, ``.M``/``.M_5_50``, sumstats and annotation
files are small delimited tables.  They are read and written here with
NumPy and the standard library, so the ``ld`` and ``h2`` commands need no
dataframe library.  The formats match what pandas' ``read_csv`` and
``to_csv`` produced for these files: a column whose fields all parse as
integers is int64, else float64 if they all parse as floats (NA tokens
become NaN), else text; floats are written with the given format and NaN
as an empty field.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import os
from typing import Iterable, Mapping

import numpy as np

#: fields read as missing (pandas' default NA strings)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})

_OPENERS = {".gz": gzip.open, ".bz2": bz2.open, ".xz": lzma.open}


def _open_text(path: str | os.PathLike, mode: str):
    opener = _OPENERS.get(os.path.splitext(str(path))[1], open)
    return opener(path, mode + "t") if opener is not open else open(path, mode)


class Table:
    """Named 1-D NumPy columns of equal length, in order."""

    def __init__(self, columns: Mapping[str, Iterable]):
        self._cols = {str(k): np.asarray(v) for k, v in columns.items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: {sorted(lengths)}")
        self._len = lengths.pop() if lengths else 0

    @classmethod
    def from_frame(cls, frame) -> "Table":
        """A Table from anything indexable by column name with a
        ``columns`` attribute (a Table or a pandas DataFrame) or a dict."""
        if isinstance(frame, Table):
            return frame
        names = frame.keys() if isinstance(frame, Mapping) else frame.columns
        return cls({c: np.asarray(frame[c]) for c in names})

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        return Table({k: self._cols[k] for k in key})

    def __setitem__(self, name: str, values) -> None:
        values = np.broadcast_to(np.asarray(values), (self._len,)).copy()
        self._cols[name] = values

    def take(self, rows) -> "Table":
        """Rows by integer index array or boolean mask."""
        return Table({k: v[rows] for k, v in self._cols.items()})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self._cols.items()})

    def to_pandas(self):
        import pandas as pd  # noqa: PLC0415

        return pd.DataFrame(self._cols)


def _parse_column(fields: list[str], na_values: frozenset[str]) -> np.ndarray:
    """int64 if every field is an integer, else float64 if every field is
    a float or NA, else text (the inference ``read_csv`` applies)."""
    has_na = any(f in na_values for f in fields)
    if not has_na:
        try:
            return np.array([int(f) for f in fields], dtype=np.int64)
        except ValueError:
            pass
    try:
        return np.array([np.nan if f in na_values else float(f)
                         for f in fields], dtype=np.float64)
    except ValueError:
        return np.array(fields, dtype=object)


def read_table(path: str | os.PathLike, *, sep: str | None = None,
               names: list[str] | None = None,
               na_values: Iterable[str] = (),
               text_columns: Iterable[str] = ()) -> Table:
    """Read a delimited text table.

    ``sep=None`` splits on runs of whitespace; ``"\\t"`` on single tabs.
    ``names`` given means the file has no header row.  ``na_values`` adds
    tokens read as missing; ``text_columns`` are kept as text without
    inference (their NA tokens become ``None``).  Compression is chosen
    from the extension (``.gz``, ``.bz2``, ``.xz``).
    """
    na = NA_VALUES | frozenset(na_values)
    with _open_text(path, "r") as f:
        rows = [ln.split(sep) if sep else ln.split()
                for ln in f.read().splitlines() if ln.strip()]
    if names is None:
        if not rows:
            raise ValueError(f"{path} is empty")
        names, rows = rows[0], rows[1:]
    width = len(names)
    for i, r in enumerate(rows):
        if len(r) != width:
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, "
                             f"expected {width}")
    fields = list(zip(*rows)) if rows else [()] * width
    text = set(text_columns)
    cols = {}
    for name, col in zip(names, fields):
        col = list(col)
        if name in text:
            cols[name] = np.array([None if f in na else f for f in col],
                                  dtype=object)
        else:
            cols[name] = _parse_column(col, na)
    return Table(cols)


def _format_column(col: np.ndarray, float_format: str | None) -> list[str]:
    if col.dtype.kind == "f":
        if float_format is None:
            out = [repr(float(v)) for v in col]
        else:
            out = np.char.mod(float_format, col).tolist()
        return ["" if np.isnan(v) else s for v, s in zip(col, out)]
    if col.dtype.kind in "iu":
        return [str(int(v)) for v in col]
    return ["" if v is None else str(v) for v in col]


def write_table(table: Table, path: str | os.PathLike, *, sep: str = "\t",
                header: bool = True, float_format: str | None = None) -> None:
    """Write ``table`` as delimited text, one row per line.

    Floats use ``float_format`` (shortest round-trip repr when None) and
    NaN is an empty field; compression follows the extension.
    """
    cols = [_format_column(table[c], float_format) for c in table.columns]
    lines = [sep.join(table.columns)] if header else []
    lines.extend(sep.join(r) for r in zip(*cols))
    with _open_text(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def sort_rows(table: Table, keys: list[str]) -> Table:
    """Stable sort by ``keys``, first key most significant."""
    order = np.arange(len(table))
    for k in reversed(keys):
        order = order[np.argsort(table[k][order], kind="stable")]
    return table.take(order)


def first_unique(values: np.ndarray) -> np.ndarray:
    """Boolean mask keeping the first occurrence of each value."""
    _, first = np.unique(values, return_index=True)
    keep = np.zeros(len(values), dtype=bool)
    keep[first] = True
    return keep


def inner_join(left: Table, right: Table, on: str) -> Table:
    """Rows of ``left`` whose key appears in ``right``, in left order,
    with ``right``'s other columns appended (``right`` keys unique)."""
    pos = {k: i for i, k in enumerate(right[on].tolist())}
    li, ri = [], []
    for i, k in enumerate(left[on].tolist()):
        j = pos.get(k)
        if j is not None:
            li.append(i)
            ri.append(j)
    li = np.asarray(li, dtype=np.int64)
    ri = np.asarray(ri, dtype=np.int64)
    cols = {c: left[c][li] for c in left.columns}
    for c in right.columns:
        if c != on:
            if c in cols:
                raise ValueError(f"column {c!r} on both sides of the join")
            cols[c] = right[c][ri]
    return Table(cols)
