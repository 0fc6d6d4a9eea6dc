"""GWAS summary-statistics reader (reference: ``nldsc/h2/common.py:29-66``).

Whitespace-delimited with columns ``SNP Z N`` (+ optional ``A1 A2``),
``.`` = NA, compression from the extension; drops NA rows and
duplicate rs numbers.
"""

from __future__ import annotations

import numpy as np

from ..core.logging import log
from .table import Table, first_unique, read_table


def read_sumstats(path: str, alleles: bool = False,
                  dropna: bool = True) -> Table:
    # compression: every extension the reference's sniffer recognized
    # (the reference passed the raw extension to pandas, which modern
    # pandas rejects — a latent bug there)
    columns = ["SNP", "Z", "N"] + (["A1", "A2"] if alleles else [])
    text = ("SNP", "A1", "A2")
    tab = read_table(path, na_values=(".",), text_columns=text)
    absent = [c for c in columns if c not in tab.columns]
    if absent:
        raise ValueError(f"{path} lacks the columns {absent}")
    data = Table({c: (tab[c] if c in text else
                      np.asarray(tab[c], dtype=np.float64))
                  for c in columns})
    if dropna:
        na = np.zeros(len(data), dtype=bool)
        for c in columns:
            col = data[c]
            na |= (np.isnan(col) if c not in text else
                   np.array([v is None for v in col], dtype=bool))
        data = data.take(~na)
    n_snp = len(data)
    data = data.take(first_unique(data["SNP"]))
    if n_snp > len(data):
        log.info("Dropped %d SNPs with duplicated rs numbers.", n_snp - len(data))
    return data
