"""PLINK IO round-trip and decoder tests."""

import numpy as np
import pytest

from nldsc_jax.io.plink import (
    BedReader, PlinkDataset, decode_bed_bytes, encode_bed_bytes, write_plink,
)
from nldsc_jax.core.errors import NLDSCDataError, NLDSCParameterError

from utils import random_genotypes


def test_encode_decode_roundtrip(rng):
    g = random_genotypes(rng, 37, 101, missing_rate=0.1)
    raw = encode_bed_bytes(g)
    assert raw.shape == (37, (101 + 3) // 4)
    back = decode_bed_bytes(raw, 101)
    np.testing.assert_array_equal(back, g)


def test_bed_reader_blocks(tmp_path, rng):
    g = random_genotypes(rng, 64, 50, missing_rate=0.05)
    prefix = write_plink(tmp_path / "toy", g)
    reader = BedReader(prefix + ".bed", n_snp=64, n_samples=50)
    np.testing.assert_array_equal(reader.read_all(), g)
    np.testing.assert_array_equal(reader.read_block(10, 7), g[10:17])
    np.testing.assert_array_equal(reader.read_block(63, 1), g[63:64])


def test_bad_magic(tmp_path):
    path = tmp_path / "bad.bed"
    path.write_bytes(b"\x00\x00\x00" + b"\x00" * 100)
    with pytest.raises(NLDSCDataError):
        BedReader(str(path), n_snp=4, n_samples=4)


def test_dataset_parse(tmp_path, rng):
    g = random_genotypes(rng, 16, 20)
    prefix = write_plink(tmp_path / "ds", g)
    for spec in (prefix, prefix + ".bed", prefix + ".bim"):
        ds = PlinkDataset.parse(spec)
        assert ds.n_snp == 16 and ds.n_samples == 20
    pos = ds.positions("bp")
    assert pos.dtype == np.float64 and len(pos) == 16
    assert (np.diff(pos) > 0).all()


def test_single_chromosome_enforced(tmp_path, rng):
    import pandas as pd

    g = random_genotypes(rng, 6, 10)
    prefix = write_plink(tmp_path / "multi", g)
    bim = pd.read_csv(prefix + ".bim", sep="\t", header=None)
    bim.iloc[3:, 0] = 21
    bim.to_csv(prefix + ".bim", sep="\t", header=False, index=False)
    with pytest.raises(NLDSCParameterError):
        PlinkDataset.parse(prefix)


def test_unpack_bed_device_matches_host_decode(tmp_path, rng):
    # device-side 2-bit unpack == the host LUT decode, incl. missing,
    # odd N (pad bitpairs in the last byte), and lane/row padding
    import jax.numpy as jnp

    from nldsc_jax.io.plink import BedReader, write_plink
    from nldsc_jax.ld.preprocess import unpack_bed
    from utils import random_genotypes

    m, n = 37, 133                      # n % 4 = 1: 3 pad bitpairs
    g = random_genotypes(rng, m, n, missing_rate=0.07)
    prefix = write_plink(tmp_path / "pk", g)
    bed = BedReader(prefix + ".bed", m, n)
    packed = bed.read_raw()
    assert packed.has_missing
    n_pad = 256
    out = np.asarray(unpack_bed(jnp.asarray(packed.raw), n_samples=n,
                                n_pad=n_pad, pad_val=-1))
    np.testing.assert_array_equal(out[:, :n], g)
    assert (out[:, n:] == -1).all()

    # no-missing variant pads with zeros
    g2 = random_genotypes(rng, m, n, missing_rate=0.0)
    prefix2 = write_plink(tmp_path / "pk2", g2)
    packed2 = BedReader(prefix2 + ".bed", m, n).read_raw()
    assert not packed2.has_missing
    out2 = np.asarray(unpack_bed(jnp.asarray(packed2.raw), n_samples=n,
                                 n_pad=n_pad, pad_val=0))
    np.testing.assert_array_equal(out2[:, :n], g2)
    assert (out2[:, n:] == 0).all()


def test_packed_pipeline_matches_array_pipeline(tmp_path, rng):
    from nldsc_jax.config import LDConfig
    from nldsc_jax.io.plink import BedReader, write_plink
    from nldsc_jax.ld.pipeline import compute_ld_scores
    from utils import make_positions, random_genotypes

    for miss in (0.0, 0.04):
        m, n = 180, 150
        g = random_genotypes(rng, m, n, missing_rate=miss)
        pos = make_positions(m, spacing=800, jitter_rng=rng)
        prefix = write_plink(tmp_path / f"pp{miss}", g,
                             bp=pos.astype(np.int64))
        packed = BedReader(prefix + ".bed", m, n).read_raw()
        cfg = LDConfig(ld_wind=6000, wind_metric="bp", maf_thr=0.01,
                       std_thr=1e-4, rsq_thr=1e-3, block_size=32)
        res_a = compute_ld_scores(g, pos, cfg)
        res_p = compute_ld_scores(packed, pos, cfg)
        for k in ("l2", "l2d", "maf", "residuals_std"):
            np.testing.assert_allclose(res_p[k], res_a[k], rtol=1e-7,
                                       atol=1e-7, equal_nan=True, err_msg=k)
        for k in ("l2_ws", "l2d_ws", "l2d_wse"):
            np.testing.assert_array_equal(res_p[k], res_a[k], err_msg=k)


def test_staged_put_chunked_identity(rng):
    """The host->device put is bitwise identical to its input and is
    timed into the transfer stage."""
    import jax

    from nldsc_jax.ld.pipeline import STAGE_TIMES, _device_put

    STAGE_TIMES.clear()
    arr = rng.integers(-1, 3, size=(37, 257)).astype(np.int8)
    out = _device_put(arr, device=jax.devices()[1])
    np.testing.assert_array_equal(np.asarray(out), arr)
    assert out.devices() == {jax.devices()[1]}
    assert STAGE_TIMES["transfer_s"] >= 0


def test_read_exact_loops_over_short_reads():
    """_read_exact must survive the kernel's single-read cap (a raw
    FileIO read(2) returns at most 2 GiB - 4 KiB on Linux — found by the
    first UKB-scale run: a 4.9 GB .bed came back truncated) and detect
    genuine truncation."""
    import pytest

    from nldsc_jax.core.errors import NLDSCDataError
    from nldsc_jax.io.plink import _read_exact

    class ShortReader:
        """readinto() that delivers at most `cap` bytes per call."""

        def __init__(self, data, cap):
            self.data, self.pos, self.cap = data, 0, cap

        def readinto(self, view):
            n = min(self.cap, len(view), len(self.data) - self.pos)
            view[:n] = self.data[self.pos:self.pos + n]
            self.pos += n
            return n

    data = bytes(range(256)) * 40                  # 10240 bytes
    out = _read_exact(ShortReader(data, cap=1000), len(data))
    assert bytes(out) == data                      # stitched exactly

    with pytest.raises(NLDSCDataError, match="truncated"):
        _read_exact(ShortReader(data, cap=1000), len(data) + 1)
