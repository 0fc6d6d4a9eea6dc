"""PLINK .bed/.bim/.fam IO, block-oriented and vectorized.

Design (SURVEY §7.1): the reference streams one SNP at a time through a C++
``BedStreamReader`` (``stream.h:9-103``); here the decoder is a *block* API —
``read_block(start, count) -> int8[count, n_samples]`` — because the device
path consumes SNP-major tiles, and a SNP range is a contiguous byte range in the
SNP-major .bed layout.

Genotype codes (counting A2 alleles, matching the reference's encoder
``encoder.h:11-16,34-40``): hom-A1 -> 0, het -> 1, hom-A2 -> 2, missing -> -1.
Bitpairs are unpacked low-to-high per the PLINK spec; the reference unpacks
high-to-low (``stream.h:63-66``, SURVEY Q7) — a fixed permutation of samples
applied identically to every SNP, so every statistic (r², MAF, residuals)
is invariant to the difference.

An optional C++ decoder (``nldsc_jax.native``) accelerates the byte->int8
unpack; the NumPy LUT path is the always-available fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..core.errors import NLDSCDataError, NLDSCParameterError
from .table import Table, read_table, write_table

PLINK_MAGIC = bytes([0x6C, 0x1B, 0x01])

BIM_COLUMNS = ("CHR", "SNP", "CM", "BP", "A1", "A2")
FAM_COLUMNS = ("FID", "IID", "FATHER", "MOTHER", "SEX", "TRAIT")

# Map 2-bit PLINK codes to additive genotype: 00->0 (hom A1), 01->missing,
# 10->het (1), 11->hom A2 (2).
_CODE_MAP = np.array([0, -1, 1, 2], dtype=np.int8)


def _build_lut() -> np.ndarray:
    """LUT[byte] -> 4 genotype codes (low bitpair first, PLINK sample order)."""
    lut = np.empty((256, 4), dtype=np.int8)
    for byte in range(256):
        for k in range(4):
            lut[byte, k] = _CODE_MAP[(byte >> (2 * k)) & 0b11]
    return lut


_BED_LUT = _build_lut()


def decode_bed_bytes(raw: np.ndarray, n_samples: int) -> np.ndarray:
    """Vectorized decode of packed .bed bytes.

    Parameters
    ----------
    raw : uint8 array with shape (n_snps, bytes_per_snp)
    n_samples : number of valid samples (trailing bitpairs are padding)

    Returns
    -------
    int8 array (n_snps, n_samples) with codes {0, 1, 2, -1}.
    """
    if raw.ndim != 2:
        raise ValueError("raw must be 2D (n_snps, bytes_per_snp)")
    decoded = _BED_LUT[raw].reshape(raw.shape[0], raw.shape[1] * 4)
    return decoded[:, :n_samples]


def encode_bed_bytes(genotypes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`decode_bed_bytes` (used by the test-data writer)."""
    codes = np.asarray(genotypes, dtype=np.int8)
    n_snp, n_samples = codes.shape
    # additive code + 1 -> 2-bit PLINK code (-1 -> 01, 0 -> 00, 1 -> 10,
    # 2 -> 11)
    to_bits = np.array([0b01, 0b00, 0b10, 0b11], dtype=np.uint8)[codes + 1]
    n_bytes = (n_samples + 3) // 4
    if n_bytes * 4 != n_samples:
        padded = np.zeros((n_snp, n_bytes * 4), dtype=np.uint8)
        padded[:, :n_samples] = to_bits
        to_bits = padded
    quads = to_bits.reshape(n_snp, n_bytes, 4)
    return (quads[..., 0] | (quads[..., 1] << 2) | (quads[..., 2] << 4)
            | (quads[..., 3] << 6))


def _read_exact(f, n: int) -> np.ndarray:
    """Read EXACTLY ``n`` bytes from an (unbuffered) file into a uint8
    array.

    ``open(..., buffering=0)`` returns a raw ``FileIO`` whose ``read``
    issues ONE ``read(2)`` syscall — Linux caps a single read at
    2 GiB − 4 KiB, so a 4.9 GB UKB-scale ``.bed`` request silently came
    back short (found the hard way: the first M=65,536 × N=300,032 CLI
    run crashed reshaping 2,147,479,552 bytes).  ``readinto`` in a loop
    is exact, keeps the zero-copy buffer, and detects real truncation.
    """
    out = np.empty(n, dtype=np.uint8)
    view = memoryview(out)
    got = 0
    while got < n:
        r = f.readinto(view[got:])
        if not r:
            raise NLDSCDataError(
                f".bed read truncated: wanted {n} bytes, got {got}")
        got += r
    return out


class BedReader:
    """Random-access block reader for a SNP-major .bed file."""

    def __init__(self, path: str | os.PathLike, n_snp: int, n_samples: int,
                 use_native: bool = True):
        self.path = str(path)
        self.n_snp = int(n_snp)
        self.n_samples = int(n_samples)
        self.bytes_per_snp = (self.n_samples + 3) // 4
        self._native = None

        with open(self.path, "rb") as f:
            magic = f.read(3)
        if magic != PLINK_MAGIC:
            raise NLDSCDataError(
                "Invalid PLINK magic number in BED file. The file is incorrect, "
                "or it was created using an incompatible version of PLINK."
            )
        expected = 3 + self.bytes_per_snp * self.n_snp
        actual = os.path.getsize(self.path)
        if actual < expected:
            raise NLDSCDataError(
                f".bed file too small: {actual} bytes, expected {expected} "
                f"(n_snp={self.n_snp}, n_samples={self.n_samples})"
            )
        if use_native:
            try:
                from ..native import bed_decode as _native  # noqa: PLC0415

                self._native = _native if _native.available() else None
            except Exception:
                self._native = None

    def read_block(self, start: int, count: int) -> np.ndarray:
        """Decode SNPs [start, start+count) -> int8 (count, n_samples)."""
        if start < 0 or start + count > self.n_snp:
            raise ValueError(f"block [{start}, {start + count}) out of range")
        if self._native is not None:
            return self._native.decode_range(
                self.path, self.n_samples, self.bytes_per_snp, start, count
            )
        with open(self.path, "rb", buffering=0) as f:
            f.seek(3 + start * self.bytes_per_snp)
            raw = _read_exact(f, count * self.bytes_per_snp)
        arr = raw.reshape(count, self.bytes_per_snp)
        return decode_bed_bytes(arr, self.n_samples)

    def read_all(self) -> np.ndarray:
        return self.read_block(0, self.n_snp)

    def read_raw(self, start: int = 0, count: int | None = None) -> "PackedBed":
        """Packed 2-bit rows [start, start+count) WITHOUT decoding.

        The device-decode path: ship these bytes to the accelerator (4×
        less transfer than int8 codes) and unpack on device
        (:func:`nldsc_jax.ld.preprocess.unpack_bed`).
        """
        count = self.n_snp - start if count is None else count
        if start < 0 or start + count > self.n_snp:
            raise ValueError(f"block [{start}, {start + count}) out of range")
        with open(self.path, "rb", buffering=0) as f:
            f.seek(3 + start * self.bytes_per_snp)
            raw = _read_exact(f, count * self.bytes_per_snp)
        arr = raw.reshape(count, self.bytes_per_snp)
        return PackedBed(arr, count, self.n_samples,
                         _packed_has_missing(arr, self.n_samples))


def _miss_bytes(raw: np.ndarray, n_samples: int) -> np.ndarray:
    """uint8 array, nonzero where a byte contains a VALID missing (01)
    bitpair.  Branch-free bitwise form (pair = b1 b0; missing ⟺ b0 ∧ ¬b1,
    so ``raw & 0x55 & ~(raw >> 1)`` lights bit 2i of pair i): three
    elementwise passes instead of a 256-entry LUT gather — ~10× faster
    over chromosome-scale byte arrays (the gather was the WHOLE
    streaming-setup cost at M=131k: 5.0 s of 5-7 s)."""
    miss = (raw & np.uint8(0x55)) & ~(raw >> 1)
    tail_pairs = n_samples - (raw.shape[1] - 1) * 4
    if tail_pairs < 4:
        # pad bitpairs in the last byte are ignored (writers are supposed
        # to zero them but need not)
        miss[:, -1] &= np.uint8((1 << (2 * tail_pairs)) - 1)
    return miss


def _packed_has_missing(raw: np.ndarray, n_samples: int) -> bool:
    """True iff any VALID bitpair is the missing code."""
    return bool(_miss_bytes(raw, n_samples).any())


def packed_rowmiss(raw: np.ndarray, n_samples: int) -> np.ndarray:
    """Per-row missing flags from packed 2-bit rows (bool (rows,)).

    The split-missing engines key on which SNP rows actually carry
    missing genotypes; one bitwise pass over the raw bytes — no decode."""
    return _miss_bytes(raw, n_samples).any(axis=1)


def scan_rowmiss(bed, block_rows: int = 65536) -> np.ndarray:
    """Per-row missing flags for a whole .bed, read in slices (bool (m,)).

    One sequential pass over the file bytes — cheap even out-of-core,
    and what lets the streaming driver pick the split-missing engine
    before any chunk is dispatched.  Reads the bytes directly (bypassing
    ``read_raw``'s own has-missing pass and row copy)."""
    m, bps = bed.n_snp, bed.bytes_per_snp
    out = np.zeros(m, dtype=bool)
    with open(bed.path, "rb", buffering=0) as f:
        f.seek(3)
        for s in range(0, m, block_rows):
            c = min(block_rows, m - s)
            raw = _read_exact(f, c * bps)
            out[s:s + c] = packed_rowmiss(raw.reshape(c, bps),
                                          bed.n_samples)
    return out


@dataclass
class PackedBed:
    """Un-decoded SNP-major .bed rows (device-decode input)."""

    raw: np.ndarray        # (n_snp, bytes_per_snp) uint8
    n_snp: int
    n_samples: int
    has_missing: bool

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_snp, self.n_samples)

    @property
    def bytes_per_snp(self) -> int:
        return self.raw.shape[1]


def read_bim(path: str | os.PathLike, single_chromosome: bool = True) -> Table:
    """Read a .bim file (reference: ``nldsc/ldscore/common.py:76-117``).

    Enforces a single chromosome per file like the reference does.
    """
    bim = read_table(path, names=list(BIM_COLUMNS),
                     text_columns=("SNP", "A1", "A2"))
    n_chr = len(set(bim["CHR"].tolist()))
    if single_chromosome and n_chr != 1:
        raise NLDSCParameterError(
            "Expected a single-chromosome bfile, but the .bim lists "
            f"{n_chr} chromosomes — split the input per "
            "chromosome (same constraint as the reference)."
        )
    return bim


def read_fam(path: str | os.PathLike) -> Table:
    return read_table(path, names=list(FAM_COLUMNS),
                      text_columns=("FID", "IID"))


@dataclass
class PlinkDataset:
    """A resolved .bed/.bim/.fam triple (reference ``PLINKFile.parse``)."""

    bed_path: str
    bim: Table
    fam: Table
    bed: BedReader

    @classmethod
    def parse(cls, bfile: str | os.PathLike, use_native: bool = True) -> "PlinkDataset":
        path = Path(bfile).resolve()
        if path.suffix in (".bed", ".bim", ".fam"):
            path = path.with_suffix("")
        elif path.is_dir():
            raise NLDSCParameterError(f"'{bfile}' is a directory, expected a file prefix")
        bed_path, bim_path, fam_path = (str(path) + s for s in (".bed", ".bim", ".fam"))
        for p in (bed_path, bim_path, fam_path):
            if not os.path.exists(p):
                raise FileNotFoundError(f'No such file: "{p}"')
        bim = read_bim(bim_path)
        fam = read_fam(fam_path)
        bed = BedReader(bed_path, n_snp=len(bim), n_samples=len(fam),
                        use_native=use_native)
        return cls(bed_path=bed_path, bim=bim, fam=fam, bed=bed)

    @property
    def n_snp(self) -> int:
        return len(self.bim)

    @property
    def n_samples(self) -> int:
        return len(self.fam)

    def positions(self, metric: str) -> np.ndarray:
        """Window coordinates: BP for 'bp' metric, CM for 'cm' (float64)."""
        col = {"bp": "BP", "cm": "CM"}[metric]
        return np.asarray(self.bim[col], dtype=np.float64)


def write_plink(prefix: str | os.PathLike, genotypes: np.ndarray,
                bim=None,
                chrom: int = 22, bp: np.ndarray | None = None,
                cm: np.ndarray | None = None) -> str:
    """Write a synthetic .bed/.bim/.fam triple (test/tool helper).

    ``genotypes``: int8 (n_snp, n_samples), codes {0,1,2,-1}.  ``bim``:
    optional table (or DataFrame) with the :data:`BIM_COLUMNS`.
    """
    prefix = str(prefix)
    codes = np.asarray(genotypes, dtype=np.int8)
    n_snp, n_samples = codes.shape

    with open(prefix + ".bed", "wb") as f:
        f.write(PLINK_MAGIC)
        f.write(encode_bed_bytes(codes).tobytes())

    if bim is None:
        if bp is None:
            bp = np.arange(1, n_snp + 1) * 1000
        if cm is None:
            cm = np.asarray(bp, dtype=np.float64) * 1e-6
        bim = Table({
            "CHR": np.full(n_snp, chrom),
            "SNP": np.array([f"rs{i + 1}" for i in range(n_snp)], dtype=object),
            "CM": np.asarray(cm, dtype=np.float64),
            "BP": np.asarray(bp),
            "A1": np.full(n_snp, "A", dtype=object),
            "A2": np.full(n_snp, "G", dtype=object),
        })
    bim = Table.from_frame(bim)
    write_table(bim[list(BIM_COLUMNS)], prefix + ".bim", header=False)

    zeros = np.zeros(n_samples, dtype=np.int64)
    fam = Table({
        "FID": np.array([f"F{i}" for i in range(n_samples)], dtype=object),
        "IID": np.array([f"I{i}" for i in range(n_samples)], dtype=object),
        "FATHER": zeros, "MOTHER": zeros, "SEX": zeros, "TRAIT": zeros - 9,
    })
    write_table(fam, prefix + ".fam", header=False)
    return prefix
