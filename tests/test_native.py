"""Native C++ .bed decoder vs NumPy LUT decoder (built on demand)."""

import os
import subprocess

import numpy as np
import pytest

from nldsc_jax.io.plink import BedReader, write_plink

from utils import random_genotypes

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "nldsc_jax", "native")


@pytest.fixture(scope="module")
def native_lib():
    lib = os.path.join(NATIVE_DIR, "libbed_decode.so")
    if not os.path.exists(lib):
        try:
            subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            pytest.skip("no C++ toolchain to build the native decoder")
    from nldsc_jax.native import bed_decode

    if not bed_decode.available():
        pytest.skip("native decoder not available")
    return bed_decode


def test_native_matches_numpy(native_lib, tmp_path, rng):
    g = random_genotypes(rng, 321, 517, missing_rate=0.06)
    prefix = write_plink(tmp_path / "nat", g)
    a = BedReader(prefix + ".bed", 321, 517, use_native=True)
    b = BedReader(prefix + ".bed", 321, 517, use_native=False)
    assert a._native is not None and b._native is None
    np.testing.assert_array_equal(a.read_all(), g)
    np.testing.assert_array_equal(a.read_block(37, 100), b.read_block(37, 100))


def test_native_rejects_bad_magic(native_lib, tmp_path):
    bad = tmp_path / "bad.bed"
    bad.write_bytes(b"\x00\x01\x02" + b"\x00" * 64)
    with pytest.raises(IOError):
        native_lib.decode_range(str(bad), 16, 4, 0, 4)
