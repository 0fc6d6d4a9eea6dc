"""Drop-in compatibility surface for reference users.

The reference exposes a low-level native API
(``nldsc/ldscore/_ldscore.pyi``): ``LDScoreParams`` (constructed with
``bfile, n_snp, n_org, ld_wind, maf, std_thr, rsq_thr, positions``),
``LDScoreResult`` (7 per-SNP vectors) and ``calculate(params)``.  This
module provides the same names/fields on top of the JAX engine so code
written against ``from ldscore import _ldscore as lds`` ports by changing
one import.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .config import LDConfig
from .io.plink import BedReader
from .ld.pipeline import compute_ld_scores


@dataclass
class LDScoreParams:
    """Reference ``LDScoreParams`` (data.h:33-66)."""

    bfile: str = ""
    n_snp: int = 0
    n_org: int = 0
    ld_wind: float = 0.0
    maf: float = 0.0
    std_thr: float = 0.0
    rsq_thr: float = 0.0
    positions: list = field(default_factory=list)


@dataclass
class LDScoreResult:
    """Reference ``LDScoreResult`` (data.h:21-31)."""

    l2: list = field(default_factory=list)
    l2d: list = field(default_factory=list)
    maf: list = field(default_factory=list)
    residuals_std: list = field(default_factory=list)
    l2_ws: list = field(default_factory=list)
    l2d_ws: list = field(default_factory=list)
    l2d_wse: list = field(default_factory=list)


def calculate(params: LDScoreParams, **engine_kwargs) -> LDScoreResult:
    """Reference ``lds.calculate`` on the JAX engine.

    The window metric is positional-agnostic here, exactly like the
    reference C++: ``positions`` already carry bp or cM values and
    ``ld_wind`` is in the same unit.
    """
    reader = BedReader(params.bfile, n_snp=params.n_snp,
                       n_samples=params.n_org)
    positions = np.asarray(params.positions, dtype=np.float64)
    # the reference C++ layer is metric-agnostic (positions already carry
    # bp or cM); 'bp' has the wider validation bound so cM windows pass too
    config = LDConfig(ld_wind=params.ld_wind, wind_metric="bp",
                      maf_thr=params.maf, std_thr=params.std_thr,
                      rsq_thr=params.rsq_thr, **engine_kwargs)
    # route big inputs through the out-of-core engine instead of holding
    # the whole dense working set in HBM (same policy as estimate_lds)
    from .ld import pipeline  # noqa: PLC0415

    dense_bytes = pipeline.dense_working_bytes(
        params.n_snp, params.n_org, engine_kwargs.get("use_int8"))
    if dense_bytes > pipeline.streaming_bytes_limit():
        from .ld.streaming import compute_ld_scores_streaming  # noqa: PLC0415

        res = compute_ld_scores_streaming(reader, positions, config)
    else:
        res = compute_ld_scores(reader.read_all(), positions, config)
    return LDScoreResult(
        l2=list(res["l2"]), l2d=list(res["l2d"]), maf=list(res["maf"]),
        residuals_std=list(res["residuals_std"]),
        l2_ws=list(res["l2_ws"]), l2d_ws=list(res["l2d_ws"]),
        l2d_wse=list(res["l2d_wse"]),
    )
