"""Executed-vs-executed LD parity: the reference's OWN C++ kernel.

``nldsc_jax/native/libref_ldscore.so`` is the reference's ``calculate()``
(/root/reference/nldsc/ldscore/_ldscore/ldscalc.h:8-65) compiled read-only
from the mounted reference tree against a minimal Armadillo-subset shim
(nldsc_jax/native/refshim/).  These tests retire PARITY.md's last
interpreted-not-executed risk items: the all-missing "poison" path
(encoder.h:99-122 -> ldscalc.h:36-46), zero-sd semantics, counters,
threshold gates, imputation, and window membership are asserted against
the reference's actual executed behavior.

Two executed-confirmed reference quirks are modeled explicitly rather
than copied into our semantics (both documented in PARITY.md):

* **Tail-byte decode** (stream.h:63-66): the reference reads each .bed
  byte HIGH bit-pair first.  For full bytes that is a within-byte sample
  permutation (statistics invariant), but for a final partial byte it
  reads the PADDING bit-pairs (decoded as hom=0) in place of real
  samples.  ``ref_view`` models the exact genotype matrix the reference
  effectively computes on.
* **Sentinel window truncation** (stream.h:182-197): ``extend_cache``
  stops extending at the first negative-position sentinel it meets, so
  the pivot whose extension hit the sentinel loses every in-window SNP
  beyond it.  Our engines/oracle deliberately include all in-window
  usable SNPs; ``reference_exec_model`` reproduces the reference's
  truncated indices for comparison.
"""

import numpy as np
import pytest

from nldsc_jax.config import LDConfig
from nldsc_jax.io.plink import write_plink
from nldsc_jax.ld.oracle import oracle_ld, preprocess
from nldsc_jax.ld.pipeline import compute_ld_scores
from nldsc_jax.native import refbinary

from utils import adversarial_genotypes, make_positions, random_genotypes

pytestmark = pytest.mark.skipif(
    not refbinary.available(),
    reason="reference tree not mounted / libref_ldscore.so unavailable")

WIND, MAF, STD, RSQ = 10_000.0, 0.01, 1e-4, 1e-3


def run_reference(tmp_path, genotypes, positions, wind=WIND, maf=MAF,
                  std=STD, rsq=RSQ):
    prefix = str(tmp_path / "refbin")
    bp = np.where(positions < 0, 1, positions).astype(np.int64)
    write_plink(prefix, genotypes, bp=bp)
    m, n = genotypes.shape
    return refbinary.calculate_reference(
        prefix + ".bed", m, n, wind, maf, std, rsq,
        np.asarray(positions, dtype=np.float64))


def ref_view(genotypes: np.ndarray) -> np.ndarray:
    """The genotype matrix the reference effectively decodes from our .bed.

    Our writer uses the PLINK spec (sample 4j+0 in the LOW bit-pair,
    zero-padding in the unused HIGH bit-pairs of the last byte); the
    reference decoder takes HIGH bit-pairs first (stream.h:63-66), i.e.
    reverses samples within each byte and, in a partial last byte, reads
    padding (code 00 -> genotype 0) instead of the low-bit real samples.
    """
    g = np.asarray(genotypes, dtype=np.int8)
    m, n = g.shape
    nb = (n + 3) // 4
    padded = np.zeros((m, nb * 4), dtype=np.int8)
    padded[:, :n] = g
    rev = padded.reshape(m, nb, 4)[:, :, ::-1].reshape(m, nb * 4)
    return np.ascontiguousarray(rev[:, :n])


def reference_exec_model(genotypes, positions, wind=WIND, maf_thr=MAF,
                         std_thr=STD, rsq_thr=RSQ) -> dict:
    """float64 simulation of ldscalc.h:23-60 INCLUDING the cache-extension
    truncation at sentinels (stream.h:182-197).  On sentinel-free data this
    coincides with ``oracle_ld``."""
    codes = np.asarray(genotypes)
    m, n = codes.shape
    positions = np.asarray(positions, dtype=np.float64)
    pre = preprocess(codes, positions, maf_thr)
    used = positions >= 0

    l2 = np.full(m, np.nan)
    l2d = np.full(m, np.nan)
    ws = np.full(m, -1, dtype=np.int64)
    wsd = np.full(m, -1, dtype=np.int64)
    wse = np.full(m, -1, dtype=np.int64)
    adj_c = (n - 1) / (n - 2)

    right = -1
    left = 0
    for cur in range(m):
        if not used[cur]:
            continue  # pass_chunk: no extension, no output
        # extend_cache: stop at first not-(used and in-window) SNP
        while right + 1 < m:
            right += 1
            if not (used[right]
                    and abs(positions[right] - positions[cur]) <= wind):
                break
        # chunk_indices over [left, right] with left-edge eviction
        idx = []
        for i in range(left, right + 1):
            inc = (pre.usable[i] and used[i]
                   and abs(positions[i] - positions[cur]) <= wind)
            if inc:
                if i != cur:
                    idx.append(i)
            elif left == i and left < cur:
                left += 1
        if not pre.usable[cur]:
            continue  # maf-dropped pivot: extension happened, no output
        idx = np.asarray(idx, dtype=np.int64)
        ws[cur] = len(idx)
        y = pre.add_std[cur]
        if pre.add_sd_zero[cur] or np.any(pre.add_sd_zero[idx]):
            l2[cur] = np.nan
        else:
            r_add = (pre.add_std[idx] @ y) / n
            l2[cur] = 1.0 + (1.0 - (1.0 - r_add ** 2) * adj_c).sum()
        dom_sel = pre.residuals_sd[idx] > std_thr
        dom_idx = idx[dom_sel]
        wsd[cur] = len(dom_idx)
        if pre.add_sd_zero[cur]:
            l2d[cur] = np.nan if len(dom_idx) > 0 else 0.0
            wse[cur] = 0
        else:
            r_dom = (pre.res_std[dom_idx] @ y) / n
            dom_terms = 1.0 - (1.0 - r_dom ** 2) * adj_c
            l2d[cur] = dom_terms.sum()
            wse[cur] = int((dom_terms > rsq_thr).sum())

    return {"l2": l2, "l2d": l2d, "maf": pre.maf,
            "residuals_std": pre.residuals_sd,
            "l2_ws": ws, "l2d_ws": wsd, "l2d_wse": wse}


def assert_parity(ref, model, rtol=2e-4, atol=2e-4):
    """Counters + NaN masks exact; values within f32-dot noise."""
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(ref[k], model[k], err_msg=k)
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_array_equal(np.isnan(ref[k]), np.isnan(model[k]),
                                      err_msg=f"NaN mask {k}")
    np.testing.assert_allclose(ref["l2"], model["l2"], rtol=rtol, atol=atol,
                               equal_nan=True, err_msg="l2")
    np.testing.assert_allclose(ref["l2d"], model["l2d"], rtol=rtol, atol=atol,
                               equal_nan=True, err_msg="l2d")
    np.testing.assert_allclose(ref["maf"], model["maf"], atol=1e-6,
                               equal_nan=True, err_msg="maf")
    np.testing.assert_allclose(ref["residuals_std"], model["residuals_std"],
                               rtol=1e-4, atol=1e-5, equal_nan=True,
                               err_msg="residuals_std")


def test_executed_parity_clean(tmp_path, rng):
    """No missing, no sentinels, N % 4 == 0: binary == oracle == engine."""
    m, n = 240, 512
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    pos = make_positions(m, spacing=997)
    ref = run_reference(tmp_path, g, pos)
    ora = oracle_ld(g, pos, WIND, MAF, STD, RSQ)
    assert_parity(ref, ora)

    cfg = LDConfig(ld_wind=WIND, wind_metric="bp", maf_thr=MAF, std_thr=STD,
                   rsq_thr=RSQ, block_size=64)
    eng = compute_ld_scores(g, pos, cfg)
    assert_parity(ref, eng)  # executed C++ vs executed engine, directly


def test_executed_parity_missing(tmp_path, rng):
    """Mean-imputation semantics, executed: 5% entry missing."""
    m, n = 200, 256
    g = random_genotypes(rng, m, n, missing_rate=0.05)
    pos = make_positions(m, spacing=1009)
    ref = run_reference(tmp_path, g, pos)
    ora = oracle_ld(g, pos, WIND, MAF, STD, RSQ)
    assert_parity(ref, ora)

    cfg = LDConfig(ld_wind=WIND, wind_metric="bp", maf_thr=MAF, std_thr=STD,
                   rsq_thr=RSQ, block_size=32)
    eng = compute_ld_scores(g, pos, cfg)
    assert_parity(ref, eng)


def test_executed_poison_and_adversarial(tmp_path, rng):
    """PARITY.md item 6/7 EXECUTED: all-missing poison row + all-het
    (zero additive sd) row + monomorphic + ultra-rare + heavy-missing."""
    n = 256
    adv = adversarial_genotypes(rng, n)
    poison = np.full((1, n), -1, dtype=np.int8)   # all-missing
    filler = random_genotypes(rng, 12, n, missing_rate=0.02)
    g = np.concatenate([filler[:6], adv, poison, filler[6:]], axis=0)
    m = g.shape[0]
    pos = make_positions(m, spacing=800)  # everything within one window
    ref = run_reference(tmp_path, g, pos)
    ora = oracle_ld(g, pos, WIND, MAF, STD, RSQ)
    assert_parity(ref, ora)

    poison_idx = 6 + len(adv)
    # the poison SNP stays "used" (NaN <= maf_thr is false) and NaNs the
    # additive sums of every neighbor, but never the dominance sums
    assert ref["l2_ws"][poison_idx] >= 0
    assert np.isnan(ref["l2"][poison_idx])
    neighbors = [i for i in range(m) if i != poison_idx
                 and ref["l2_ws"][i] >= 0]
    assert all(np.isnan(ref["l2"][i]) for i in neighbors)
    finite_dom = [i for i in neighbors if not np.isnan(ref["l2d"][i])]
    assert len(finite_dom) > 0  # dominance sums survive the poison


def test_executed_maf_drop_boundary(tmp_path, rng):
    """maf <= thr drops (INclusive), executed with an exact-boundary SNP.

    The boundary must be a dyadic rational: the reference stores maf as
    float32 (encoder.h:47,114-118), so a non-representable threshold like
    0.05 rounds f32(maf) just above the f64 threshold and flips the drop
    decision — a knife-edge, not a semantic.  51/1024 is exact in both."""
    n = 512
    thr = 51.0 / 1024.0
    row = np.zeros(n, dtype=np.int8)
    row[:51] = 1  # folded maf = 51/1024 exactly, in f32 and f64 alike
    g = np.concatenate(
        [random_genotypes(rng, 8, n, missing_rate=0.0, maf_low=0.2),
         row[None, :],
         random_genotypes(rng, 8, n, missing_rate=0.0, maf_low=0.2)], axis=0)
    pos = make_positions(g.shape[0], spacing=500)
    ref = run_reference(tmp_path, g, pos, maf=thr)
    ora = oracle_ld(g, pos, WIND, thr, STD, RSQ)
    assert_parity(ref, ora)
    assert ref["l2_ws"][8] == -1          # dropped: maf == thr
    assert np.isclose(ref["maf"][8], thr, atol=1e-9)  # but maf recorded


def test_executed_window_boundary_inclusive(tmp_path, rng):
    """dist == ld_wind is INCLUDED (tools.h:45-46), executed."""
    n = 256
    g = random_genotypes(rng, 5, n, missing_rate=0.0)
    pos = np.array([0.0, 1000.0, 2000.0, 3000.0, 4001.0])
    ref = run_reference(tmp_path, g, pos, wind=2000.0)
    ora = oracle_ld(g, pos, 2000.0, MAF, STD, RSQ)
    assert_parity(ref, ora)
    assert ref["l2_ws"][0] == 2  # SNPs at 1000 and exactly 2000


def test_executed_sentinel_truncates_window(tmp_path, rng):
    """DIVERGENCE, executed-confirmed: a negative-position sentinel stops
    the reference's cache extension (stream.h:196), so the pivot whose
    extension first reached it loses every in-window SNP beyond it.  Our
    engines keep those SNPs (the window predicate alone decides
    membership); PARITY.md records this as a deliberate non-bug-for-bug
    divergence."""
    m, n = 16, 256
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    pos = make_positions(m, spacing=900, skip_idx=(7,))
    ref = run_reference(tmp_path, g, pos)
    model = reference_exec_model(g, pos)
    assert_parity(ref, model)

    ora = oracle_ld(g, pos, WIND, MAF, STD, RSQ)
    # extension is greedy, so the FIRST pivot whose extension reached the
    # sentinel (pivot 0 here: its window spans index 7) is truncated;
    # the oracle (and our engines) count its full window
    truncated = np.flatnonzero(ref["l2_ws"] < ora["l2_ws"])
    np.testing.assert_array_equal(truncated, [0])
    # pivots past the sentinel recover the full window
    np.testing.assert_array_equal(ref["l2_ws"][8:], ora["l2_ws"][8:])


def test_executed_tail_byte_quirk(tmp_path, rng):
    """DIVERGENCE, executed-confirmed: with N % 4 != 0 the reference reads
    the last byte HIGH bit-pairs first (stream.h:60-66), i.e. PADDING
    (decoded hom=0) in place of low-bit real samples.  ``ref_view`` models
    the matrix it effectively computes on; our decoder follows the PLINK
    spec."""
    m, n = 24, 255  # r = 3: reference reads [pad, s2, s1], loses s0
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    pos = make_positions(m, spacing=700)
    ref = run_reference(tmp_path, g, pos)
    model = oracle_ld(ref_view(g), pos, WIND, MAF, STD, RSQ)
    assert_parity(ref, model)
    # and it genuinely differs from the true-genotype scores
    ora = oracle_ld(g, pos, WIND, MAF, STD, RSQ)
    both = ~(np.isnan(ref["l2"]) | np.isnan(ora["l2"]))
    assert np.abs(ref["l2"][both] - ora["l2"][both]).max() > 1e-3


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_executed_fuzz_parity(tmp_path, seed):
    """Randomized executed-vs-model sweep: random missing + interior
    sentinels + cm-metric fractional positions; the reference_exec_model
    (window-predicate semantics plus the sentinel-truncation quirk) must
    reproduce the binary exactly on counters and within f32 noise on
    scores.  N % 4 == 0 keeps the tail-byte quirk out of scope (pinned
    separately)."""
    rng = np.random.default_rng(seed)
    m, n = rng.integers(60, 200), int(rng.integers(16, 100)) * 4
    g = random_genotypes(rng, m, n, missing_rate=float(rng.uniform(0, 0.1)))
    # fractional cm-style positions with jitter; a couple of interior
    # sentinels (never trailing: the reference reads uninitialized cache
    # entries for trailing sentinels — an inherited UB, see refbinary)
    pos = np.sort(rng.uniform(0.0, 50.0, size=m))
    for i in rng.choice(np.arange(1, m - 2), size=2, replace=False):
        pos[i] = -1.0
    wind = float(rng.uniform(2.0, 30.0))
    maf = float(rng.uniform(0.0, 0.1))
    ref = run_reference(tmp_path, g, pos, wind=wind, maf=maf)
    model = reference_exec_model(g, pos, wind=wind, maf_thr=maf)
    assert_parity(ref, model)


def test_executed_split_engine_parity(tmp_path, rng):
    """Row-missing data through the split-missing engine vs the executed
    binary (the engine-selection path production actually takes)."""
    m, n = 160, 256
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    contaminated = rng.choice(m, size=max(2, m // 50), replace=False)
    for i in contaminated:
        miss = rng.random(n) < 0.08
        g[i] = np.where(miss, np.int8(-1), g[i])
    pos = make_positions(m, spacing=1100)
    ref = run_reference(tmp_path, g, pos)
    cfg = LDConfig(ld_wind=WIND, wind_metric="bp", maf_thr=MAF, std_thr=STD,
                   rsq_thr=RSQ, block_size=32)
    eng = compute_ld_scores(g, pos, cfg)
    assert_parity(ref, eng)
