"""Cross-engine preprocessing consistency: f32 path vs integer path.

Both compute the same per-SNP statistics through different algebra
(two-pass centered vs integer moments + corrections); they must agree.
"""

import numpy as np

import jax.numpy as jnp

from nldsc_jax.ld.ld_int8 import preprocess_int8
from nldsc_jax.ld.preprocess import preprocess_block

from utils import adversarial_genotypes, random_genotypes


def _run_both(g, n):
    pos_ok = jnp.ones(g.shape[0], bool)
    f32 = preprocess_block(jnp.asarray(g), pos_ok, jnp.float32(0.01),
                           n_samples=n)
    i8 = preprocess_int8(jnp.asarray(g), pos_ok, jnp.float32(0.01),
                         n_samples=n)
    return f32, i8


def test_scalar_stats_agree(rng):
    g = random_genotypes(rng, 60, 500, missing_rate=0.05)
    f32, i8 = _run_both(g, 500)
    np.testing.assert_allclose(np.asarray(i8["maf"]), np.asarray(f32["maf"]),
                               rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(np.asarray(i8["rstd"]), np.asarray(f32["rstd"]),
                               rtol=1e-4, atol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(np.asarray(i8["usable"]),
                                  np.asarray(f32["usable"]))
    np.testing.assert_array_equal(np.asarray(i8["add_sd_zero"]),
                                  np.asarray(f32["add_sd_zero"]))


def test_scalar_stats_agree_adversarial(rng):
    g = adversarial_genotypes(rng, 256)
    f32, i8 = _run_both(g, 256)
    np.testing.assert_allclose(np.asarray(i8["maf"]), np.asarray(f32["maf"]),
                               rtol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(np.asarray(i8["usable"]),
                                  np.asarray(f32["usable"]))
    np.testing.assert_array_equal(np.asarray(i8["add_sd_zero"]),
                                  np.asarray(f32["add_sd_zero"]))


def test_integer_codes(rng):
    g = random_genotypes(rng, 20, 100, missing_rate=0.1)
    _, i8 = _run_both(g, 100)
    gq = np.asarray(i8["g"])
    mq = np.asarray(i8["m"])
    hq = np.asarray(i8["h"])
    miss = g < 0
    np.testing.assert_array_equal(mq, miss.astype(np.int8))
    np.testing.assert_array_equal(gq, np.where(miss, 0, g))
    np.testing.assert_array_equal(hq, np.where(miss, 0, np.minimum(g, 1) * 2))
