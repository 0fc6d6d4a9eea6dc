"""Centralized, validated configuration.

The reference scatters defaults across the CLI and function signatures
(SURVEY Q10/Q11); here every tunable lives in one frozen dataclass.
Validation bounds mirror the reference value-classes
(``nldsc/ldscore/common.py:10-36,146-182``):

* window: > 0; ≤ 5 Mbp for bp metric; ≤ 100 for cM metric
* maf threshold:   0 ≤ v < 1
* std threshold:   0 ≤ v < 1
* rsq threshold:   0 ≤ v < 0.1   (``None`` → 1 / n_snp at run time,
  per ``nldsc/ldscore/routine.py:70-72``)
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from .core.errors import NLDSCParameterError

MAX_WIND_BP = 5_000_000.0
MAX_WIND_CM = 100.0


@dataclass(frozen=True)
class LDConfig:
    """Parameters of the LD-score pass (reference ``LDScoreParams``, data.h:33-66)."""

    ld_wind: float
    wind_metric: str = "bp"  # 'bp' | 'cm' ('kbp' accepted, converted to bp)
    maf_thr: float = 1e-5
    std_thr: float = 1e-5
    rsq_thr: float | None = None  # None -> 1/n_snp

    # --- device engine knobs (no reference analog) ---
    block_size: int = 512          # SNP rows per tile (multiple of 8)
    symmetric: bool | None = None  # exploit r² symmetry (half-band + row/col
                                   # credit); None = auto: always on
                                   # (scripts/time_sym2.py compares it
                                   # with full-band)
    use_int8: bool | None = None   # integer-exact engine (int8/bf16
                                   # matmuls + analytic corrections);
                                   # None = auto (always on)
    int8_dot_dtype: str = "int8"   # 'int8' (int8x8->int32, exact) |
                                   # 'bf16' (exact f32 accumulation,
                                   # N_pad <= 4M)
    split_missing: bool | None = None  # per-row missing specialization:
                                   # clean 3-matmul pass + compact exact
                                   # corrections (ld_split.py); None =
                                   # auto (on when ≤25% of usable rows
                                   # carry missing genotypes)

    def __post_init__(self):
        wind = float(self.ld_wind)
        metric = self.wind_metric
        if metric == "kbp":
            wind *= 1000.0
            metric = "bp"
        object.__setattr__(self, "ld_wind", wind)
        object.__setattr__(self, "wind_metric", metric)
        self._validate()

    def _validate(self):
        if self.wind_metric not in ("bp", "cm"):
            raise NLDSCParameterError("Invalid metric")
        if self.ld_wind <= 0:
            raise NLDSCParameterError("The ld-window must be greater than 0")
        if self.wind_metric == "bp" and self.ld_wind > MAX_WIND_BP:
            raise NLDSCParameterError("The ld-window cannot be larger than 5 Mbp")
        if self.wind_metric == "cm" and self.ld_wind > MAX_WIND_CM:
            raise NLDSCParameterError("The ld-window cannot be larger than 100 cm")
        if not (0 <= self.maf_thr < 1):
            raise NLDSCParameterError(
                f"MAF threshold {self.maf_thr} out of range [0, 1)")
        if not (0 <= self.std_thr < 1):
            raise NLDSCParameterError(
                f"residual-sd threshold {self.std_thr} out of range [0, 1)")
        if self.rsq_thr is not None and not (0 <= self.rsq_thr < 0.1):
            raise NLDSCParameterError(
                f"r-squared threshold {self.rsq_thr} out of range [0, 0.1)")
        if self.block_size % 8 != 0 or self.block_size <= 0:
            raise NLDSCParameterError("block_size must be a positive multiple of 8")

    def resolve_rsq(self, n_snp: int) -> "LDConfig":
        """Fill the default rsq threshold (1/n_snp, routine.py:70-72)."""
        if self.rsq_thr is not None:
            return self
        return replace(self, rsq_thr=1.0 / n_snp)


@dataclass(frozen=True)
class H2Config:
    """Parameters of the h2 regression (reference ``estimate_h2`` signature)."""

    n_blocks: int = 200
    intercept_h2: float | None = None
    chisq_max: float | None = None  # None -> max(1e-3 * N_max, 80)
    two_step: float | None = None   # None -> 30 when intercept free
    strategy: str = "two-stg"
    use_m: bool = False             # prefer .M over .M_5_50 sidecar
    slow_jackknife: bool = False
    on_device: bool = False         # run the regression in f32 on the
                                    # default accelerator (compensated
                                    # jackknife sums; measured ≤1e-5 vs
                                    # the f64 CPU path) instead of f64
                                    # on CPU

    def __post_init__(self):
        if self.strategy not in ("one-stg", "two-stg"):
            raise NLDSCParameterError(
                "Unknown estimation strategy. Only `one-stg` and `two-stg` are allowed"
            )
        if self.n_blocks < 2:
            raise NLDSCParameterError("n_blocks must be >= 2")
