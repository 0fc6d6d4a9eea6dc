"""End-to-end LD-score estimation (the ``nldsc ld`` workload).

Pipeline (redesign of ``nldsc/ldscore/routine.py:51-102``):

  host: parse .bim/.fam → window bounds (exact f64 → index intervals)
        → block-decode .bed to int8 SNP-major tiles
  device: fused preprocess (impute/standardize/residualize)
        → banded block-correlation matmuls (XLA)
  host: NaN/-1 sentinel assembly → .L2 TSV + .M/.M_5_50
"""

from __future__ import annotations

import time
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from ..config import LDConfig
from ..core.logging import log
from ..core.timing import STAGE_TIMES, elapsed_time
from ..core.timing import stage_add as _stage_add
from ..io.ldscores import make_output, write_l2, write_m_files
from ..io.plink import PlinkDataset
from . import ld_xla, preprocess, windows

#: one jitted finalize shared by the segmented/split dispatch paths (an
#: eager call would pay one runtime dispatch per jnp op)
_finalize_jit = jax.jit(ld_xla.finalize_outputs)

_finalize_annot_cache = None


def _finalize_annot_jit():
    """Lazily-created shared jit of ``ld_int8.finalize_annot`` (module
    import deferred like the engine imports; one wrapper so the jit cache
    is shared across calls)."""
    global _finalize_annot_cache
    if _finalize_annot_cache is None:
        from . import ld_int8  # noqa: PLC0415
        _finalize_annot_cache = jax.jit(ld_int8.finalize_annot)
    return _finalize_annot_cache


# STAGE_TIMES (re-exported from core.timing above): stage decomposition
# of the LAST ``estimate_lds`` call — ``disk_s`` (.bed read),
# ``transfer_s`` (host→device staging), ``device_s`` (preprocess +
# engine + result fetch), ``write_s`` (TSV + sidecars); the streaming
# route adds its component busy-times.  bench.py emits these so a slow
# end-to-end number is attributable (VERDICT r4 #6).


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if x.shape[0] == size:
        return x
    pad_shape = (size - x.shape[0],) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)], axis=0)


def _bucket_rows(m_pad: int, B: int) -> int:
    """Round the padded row count up to the next {1, 1.5} × 2^k multiple
    of the block size (waste ≤ 33%).

    Every distinct (m_pad, right_k/band_k) tuple compiles its own
    executable; a 22-chromosome genome has 22 distinct sizes, so without
    bucketing `ld-genome` pays one compile per chromosome, which can
    cost more than the chromosome's compute (scripts/time_genome.py).
    Bucketing collapses a genome to ~4 shared programs; padded rows have
    empty windows and unusable flags, so outputs are unchanged.
    """
    nb = -(-m_pad // B)
    b = 1
    while b < nb:
        b *= 2
    if b > nb and (b // 2) * 3 // 2 >= nb:
        b = (b // 2) * 3 // 2
    return b * B


def _bucket_k(k: int, step: int = 2) -> int:
    """Round a band width in blocks up to a multiple of ``step`` (a wider
    band only adds masked, never-counted pairs)."""
    return max(step, -(-k // step) * step)


def _device_put(arr: np.ndarray, device=None):
    """Host→device transfer, timed into ``STAGE_TIMES["transfer_s"]``."""
    t0 = time.time()
    out = jax.device_put(arr, device)
    out.block_until_ready()
    _stage_add("transfer_s", t0)
    return out


def to_host_result(l2, l2d, ws, wsd, wse, maf, rstd, m: int) -> dict:
    """Assemble the reference ``LDScoreResult`` fields on host (first m rows)."""
    return {
        "l2": np.asarray(l2, dtype=np.float64)[:m],
        "l2d": np.asarray(l2d, dtype=np.float64)[:m],
        "maf": np.asarray(maf, dtype=np.float64)[:m],
        "residuals_std": np.asarray(rstd, dtype=np.float64)[:m],
        "l2_ws": np.asarray(ws, dtype=np.int64)[:m],
        "l2d_ws": np.asarray(wsd, dtype=np.int64)[:m],
        "l2d_wse": np.asarray(wse, dtype=np.int64)[:m],
    }


def compute_ld_scores(genotypes: np.ndarray, positions: np.ndarray,
                      config: LDConfig, *, annot: np.ndarray | None = None,
                      device=None, progress=None,
                      bucket_shapes: bool = False) -> dict:
    """LD scores for an in-core genotype matrix.

    Parameters
    ----------
    genotypes : int8 (M, N) codes {0,1,2,-1}
    positions : float64 (M,); negative = skip sentinel
    config : LDConfig with ``rsq_thr`` resolved
    annot : optional float (M, p) annotation matrix — partitioned LD.
        Extends the result with ``l2_annot``/``l2d_annot`` (M, p) arrays.
        Engine routing (scripts/time_annot.py compares them): clean annot
        runs FULL-BAND (the symmetric scan serializes the skinny annot
        contractions; lax.map overlaps them), annot with missing data
        runs the SYMMETRIC form so the split-missing corrections compose
        (their δ-credits extend to the annot accumulators).  Explicit
        ``config.symmetric`` overrides.
    progress : optional callable ``progress(done_rows, total_rows)`` —
        when given (and the default int8-symmetric engine is selected) the
        pass is dispatched in pivot segments with a completion fetch after
        each, so the callback ticks with real device progress (reference
        UX: the per-SNP ``indicators.h`` bar).  Costs one host sync per
        segment; intended for minutes-long runs.

    Returns
    -------
    dict of host float64/int64 arrays: l2, l2d, maf, residuals_std,
    l2_ws, l2d_ws, l2d_wse — the reference ``LDScoreResult`` fields.

    ``genotypes`` may also be an :class:`nldsc_jax.io.plink.PackedBed`
    (un-decoded 2-bit rows): the codes are then unpacked ON DEVICE,
    shipping 4× fewer bytes host→device — the default ingestion path.
    """
    from ..io.plink import PackedBed  # noqa: PLC0415

    packed = isinstance(genotypes, PackedBed)
    m, n = genotypes.shape
    B = config.block_size
    m_pad = -(-m // B) * B
    if bucket_shapes:
        # genome runs: share compiled programs across chromosome sizes
        m_pad = _bucket_rows(m_pad, B)
    n_pad = -(-n // 128) * 128

    lo, hi, pos_ok = windows.window_bounds(positions, config.ld_wind)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, m_pad // B)
    if bucket_shapes:
        band_k = _bucket_k(band_k)

    # padding-only missingness collapses analytically in the int8 engine,
    # so only REAL missing genotypes force the 6/8-matmul paths.  With no
    # real missing, pad with ZEROS and let preprocess alias g/m (skips two
    # O(M·N) int8 materializations — the algebra is invariant, see
    # preprocess_int8).
    has_missing = (genotypes.has_missing if packed
                   else bool((genotypes < 0).any()))
    use_int8 = config.use_int8 if config.use_int8 is not None else True
    pad_val = np.int8(-1) if (has_missing or not use_int8) else np.int8(0)

    a_dev = (None if annot is None else
             jnp.asarray(_pad_to(np.ascontiguousarray(annot,
                                                      dtype=np.float32),
                                 m_pad, 0.0), device=device))

    pos_ok_pad = _pad_to(pos_ok, m_pad, False)
    lo_pad = _pad_to(lo, m_pad, np.int32(m_pad))   # empty window for padding
    hi_pad = _pad_to(hi, m_pad, np.int32(-1))

    if packed:
        # pad ROWS in byte space (0x55 = four missing bitpairs, 0x00 =
        # four zero codes — consistent with pad_val); columns are handled
        # inside the device unpack
        pad_byte = np.uint8(0x55) if pad_val == -1 else np.uint8(0x00)
        raw = _pad_to(genotypes.raw, m_pad, pad_byte)
        raw_dev = _device_put(raw, device=device)
        g_dev = preprocess.unpack_bed(raw_dev, n_samples=n, n_pad=n_pad,
                                      pad_val=int(pad_val))
    else:
        g = _pad_to(genotypes.astype(np.int8), m_pad, pad_val)
        if n_pad != n:
            g = np.concatenate(
                [g, np.full((m_pad, n_pad - n), pad_val, dtype=np.int8)],
                axis=1)
        g_dev = _device_put(g, device=device)
    t_dev = time.time()

    # the one-pass symmetric engine is the default with and without
    # missing data (scripts/time_sym2.py compares it with full-band).
    # Annot flips the clean default to full-band (scripts/time_annot.py:
    # the annot contractions sit on the symmetric scan's critical path)
    # but keeps symmetric when missing data makes the split-corrections
    # composition available.
    if annot is None:
        symmetric = config.symmetric if config.symmetric is not None else True
    else:
        symmetric = (config.symmetric if config.symmetric is not None
                     else has_missing)

    if use_int8:
        from . import ld_int8  # noqa: PLC0415
        # the symmetric XLA route either runs clean-scan + compact split
        # corrections (m read only through the contaminated rows) or
        # decides it needs the global epilogue AFTER seeing the per-row
        # missing counts — defer the O(M·N) indicator materialization to
        # that decision instead of paying it up front
        lazy_m = has_missing and symmetric
        pre = ld_int8.preprocess_int8(
            g_dev, jnp.asarray(pos_ok_pad), jnp.float32(config.maf_thr),
            n_samples=n, assume_no_missing=not has_missing,
            materialize_m=not lazy_m)
        dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(config.std_thr))
        int8_args = (
            pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            jnp.asarray(lo_pad), jnp.asarray(hi_pad), pre["usable"], dom_ok,
            pre["add_sd_zero"], jnp.asarray(blk_lo), jnp.asarray(blk_hi),
            jnp.float32(config.rsq_thr))
        if symmetric:
            right_k = windows.right_band_blocks(blk_hi, B)
            if bucket_shapes:
                right_k = _bucket_k(right_k)
            n_blocks = m_pad // B
            # --- per-row missing specialization (split engine) ---
            # the global has_missing static forces the 8-matmul epilogue on
            # EVERY tile; when only a minority of rows actually carry
            # missing genotypes, the split engine runs the 3-matmul clean
            # pass everywhere and corrects contaminated pairs against
            # compacted rows (cost ∝ contaminated fraction).
            split_plan = None
            use_missing = has_missing
            if has_missing:
                from . import ld_split  # noqa: PLC0415
                usable_h = np.asarray(pre["usable"])
                rowmiss_h = (np.asarray(pre["cm"]) > (n_pad - n)) & usable_h
                frac = float(rowmiss_h.mean())
                want_split = (config.split_missing
                              if config.split_missing is not None
                              else frac <= 0.25)
                if not rowmiss_h.any():
                    # every contaminated row is unusable: no counted pair
                    # touches missing data — the clean epilogue is exact
                    use_missing = False
                elif want_split:
                    # v2 segmented corrections: the clean scan runs
                    # unmodified over all pairs; one extra dispatch adds
                    # exact δ-credits for contaminated pairs, with x
                    # swept in LARGE segments so each big operand is
                    # read once per segment (per-block correction
                    # launches are K-loop-bound)
                    split_plan = ld_split.plan_split_v2(
                        rowmiss_h, lo_pad, hi_pad,
                        min(ld_split.SEG_ROWS_DEFAULT, m_pad), m_pad)
                    log.info("Split-missing engine: %.2f%% contaminated "
                             "rows (P=%d, Px=%d, %d segments)",
                             100.0 * frac, split_plan["p_band"],
                             split_plan["p_x"], split_plan["n_segs"])
                    split_dev = (jnp.asarray(rowmiss_h),
                                 jnp.asarray(split_plan["miss_idx"]),
                                 jnp.asarray(split_plan["cs"]),
                                 jnp.asarray(split_plan["c_cnt"]),
                                 jnp.asarray(split_plan["xs"]),
                                 jnp.asarray(split_plan["x_cnt"]))

            # the deferred indicator matrix: compact rows for the split
            # path, full only when the global epilogue is truly selected
            if lazy_m and use_missing and split_plan is None:
                int8_args = (int8_args[:1]
                             + (ld_int8.materialize_missing(g_dev),)
                             + int8_args[2:])

            def run_segment(s0: int, nb_s: int):
                scan_args = int8_args[:9] + (int8_args[11],)
                return ld_int8.sym_scan_segment(
                    *scan_args, jnp.int32(s0), a_dev, block_size=B,
                    right_k=right_k, n_samples=n, n_scan_blocks=nb_s,
                    has_missing=(use_missing if split_plan is None
                                 else False),
                    dot_dtype=config.int8_dot_dtype)

            # dispatch the δ-corrections FIRST (async) so the progress
            # ticks below account for the whole pass, not just the scan
            deltas = None
            if split_plan is not None:
                m_c = ld_split.compact_missing_rows(g_dev, split_dev[1])
                deltas = ld_split.split_corrections(
                    pre["g"], m_c, pre["h"], int8_args[3],
                    int8_args[4], int8_args[5], pre["usable"], dom_ok,
                    split_dev[0], int8_args[11], jnp.int32(m_pad),
                    *split_dev[1:], a_dev,
                    seg_rows=split_plan["seg_rows"],
                    n_segs=split_plan["n_segs"],
                    p_band=split_plan["p_band"], p_x=split_plan["p_x"],
                    n_samples=n, dot_dtype=config.int8_dot_dtype)

            if progress is not None and n_blocks > 1:
                n_seg = min(16, n_blocks)
                seg_blocks = -(-n_blocks // n_seg)
                totals = None
                done = 0
                progress(0, m)
                for s0 in range(0, n_blocks, seg_blocks):
                    nb_s = min(seg_blocks, n_blocks - s0)
                    accs = run_segment(s0, nb_s)
                    totals = (accs if totals is None else
                              jax.tree.map(jnp.add, totals, accs))
                    np.asarray(accs[0][:1])        # completion fence
                    done = min(done + nb_s * B, m)
                    progress(done, m)
            else:
                totals = run_segment(0, n_blocks)
            l2_c, ws_c, poi_c, l2d_c, wsd_c, wse_c = totals[:6]
            l2a_c = l2da_c = None
            if a_dev is not None:
                l2a_c, l2da_c = totals[6:]
            if deltas is not None:
                l2_d, l2d_d, wse_d = deltas[:3]
                l2_c = l2_c + l2_d
                l2d_c = l2d_c + l2d_d
                wse_c = wse_c + wse_d
                if a_dev is not None:
                    l2a_c = l2a_c + deltas[3]
                    l2da_c = l2da_c + deltas[4]
            l2, l2d, ws, wsd, wse = _finalize_jit(
                l2_c, l2d_c, ws_c, wsd_c, wse_c, poi_c,
                pre["usable"], pre["add_sd_zero"])
            if a_dev is not None:
                l2_a, l2d_a = _finalize_annot_jit()(
                    l2a_c, l2da_c, a_dev, pre["usable"],
                    pre["add_sd_zero"], poi_c, wsd_c)
        elif a_dev is not None:
            l2_a, l2d_a, l2, l2d, ws, wsd, wse = ld_int8.ld_scores_int8(
                *int8_args, a_dev, block_size=B, band_k=band_k, n_samples=n,
                has_missing=has_missing, dot_dtype=config.int8_dot_dtype)
        else:
            l2, l2d, ws, wsd, wse = ld_int8.ld_scores_int8(
                *int8_args, block_size=B, band_k=band_k, n_samples=n,
                has_missing=has_missing, dot_dtype=config.int8_dot_dtype)
        out = to_host_result(l2, l2d, ws, wsd, wse, pre["maf"], pre["rstd"], m)
        if a_dev is not None:
            out["l2_annot"] = np.asarray(l2_a, dtype=np.float64)[:m]
            out["l2d_annot"] = np.asarray(l2d_a, dtype=np.float64)[:m]
        _stage_add("device_s", t_dev)
        return out

    pre = preprocess.preprocess_block(
        g_dev, jnp.asarray(pos_ok_pad), jnp.float32(config.maf_thr),
        n_samples=n)

    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(config.std_thr))

    args = (pre["add"], pre["res"], jnp.asarray(lo_pad), jnp.asarray(hi_pad),
            pre["usable"], dom_ok, pre["add_sd_zero"],
            jnp.asarray(blk_lo), jnp.asarray(blk_hi))
    if a_dev is not None:
        # the f32 annot epilogue exists full-band only
        l2_a, l2d_a, l2, l2d, ws, wsd, wse = ld_xla.ld_scores_xla_annot(
            *args, jnp.float32(config.rsq_thr), a_dev,
            block_size=B, band_k=band_k, n_samples=n)
        out = to_host_result(l2, l2d, ws, wsd, wse, pre["maf"], pre["rstd"], m)
        out["l2_annot"] = np.asarray(l2_a, dtype=np.float64)[:m]
        out["l2d_annot"] = np.asarray(l2d_a, dtype=np.float64)[:m]
        _stage_add("device_s", t_dev)
        return out
    if symmetric:
        right_k = windows.right_band_blocks(blk_hi, B)
        if bucket_shapes:
            right_k = _bucket_k(right_k)
        l2, l2d, ws, wsd, wse = ld_xla.ld_scores_xla_sym(
            *args, jnp.float32(config.rsq_thr), block_size=B, band_k=band_k,
            right_k=right_k, n_samples=n)
    else:
        l2, l2d, ws, wsd, wse = ld_xla.ld_scores_xla(
            *args, jnp.float32(config.rsq_thr), block_size=B, band_k=band_k,
            n_samples=n)

    out = to_host_result(l2, l2d, ws, wsd, wse, pre["maf"], pre["rstd"], m)
    _stage_add("device_s", t_dev)
    return out


def compute_ld_scores_annot(genotypes: np.ndarray, positions: np.ndarray,
                            annot: np.ndarray, config: LDConfig, *,
                            device=None) -> dict:
    """Partitioned LD scores — thin wrapper over
    :func:`compute_ld_scores` with ``annot`` (kept for API stability).

    Returns the standard result dict extended with ``l2_annot`` and
    ``l2d_annot`` (M, p) float64 arrays.  Engine routing (incl. the
    split-missing composition) is documented on :func:`compute_ld_scores`.
    """
    return compute_ld_scores(genotypes, positions, config, annot=annot,
                             device=device)


def _pair_corr(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson correlation over the rows where both are defined."""
    ok = ~(np.isnan(x) | np.isnan(y))
    return float(np.corrcoef(x[ok], y[ok])[0, 1]) if ok.sum() > 1 else np.nan


_SUMMARY_STATS = {
    "mean": np.nanmean, "std": lambda v: np.nanstd(v, ddof=1),
    "min": np.nanmin, "25%": lambda v: np.nanpercentile(v, 25),
    "50%": np.nanmedian, "75%": lambda v: np.nanpercentile(v, 75),
    "max": np.nanmax}


def show_summary(result: dict) -> str:
    """Post-run sanity summary (reference show_summary, routine.py:15-29):
    pairwise-complete correlations and NaN-skipping column statistics."""
    names = ("L2", "L2D", "MAF")
    cols = [np.asarray(result[k], dtype=np.float64)
            for k in ("l2", "l2d", "maf")]

    def rows(items):
        return [f"{'':<6}" + "".join(f"{n:>12}" for n in names)] + [
            f"{label:<6}" + "".join(f"{v:>12.6f}" for v in vals)
            for label, vals in items]

    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # all-NaN columns
        corr = rows((n, [_pair_corr(x, y) for y in cols])
                    for n, x in zip(names, cols))
        desc = rows((s, [f(c) if np.isfinite(c).any() else np.nan
                         for c in cols]) for s, f in _SUMMARY_STATS.items())
    n_l2, n_l2d = (int((~np.isnan(c)).sum()) for c in cols[:2])
    text = "\n".join([
        "=" * 62, "L2/L2D/MAF Correlation matrix", *corr, "",
        "Short summary:",
        f"- Number of additive non-null LD: {n_l2}",
        f"- Number of non-additive non-null LD: {n_l2d}",
        *desc, "=" * 62])
    print(text)
    return text


#: auto-streaming limit on the CPU backend, which reports no memory_stats
CPU_STREAMING_BYTES = 8 << 30


def streaming_bytes_limit(device=None) -> int:
    """Dense working-set size above which the LD pass streams.

    Half of the device memory that JAX may use (``bytes_limit``), leaving
    the other half for the engines' temporaries.  The CPU backend has no
    such limit and uses :data:`CPU_STREAMING_BYTES`; an accelerator that
    does not report one is an error rather than a guess.
    """
    device = jax.devices()[0] if device is None else device
    if device.platform == "cpu":
        return CPU_STREAMING_BYTES
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{device.device_kind} reports no memory_stats()['bytes_limit'];"
            " pass streaming=True/False (--streaming/--no-streaming)")
    return int(limit) // 2


def dense_working_bytes(n_snp: int, n_samples: int,
                        use_int8: bool | None) -> int:
    """Device bytes the in-core engines hold: int8 engines keep g/m/h int8
    copies (m aliases g when clean), f32 engines keep add/res f32 rows."""
    bpe = 3 if (use_int8 is None or use_int8) else 8
    return bpe * n_snp * (-(-n_samples // 128) * 128)


def _grid_shape(n_dev: int) -> tuple[int, int] | None:
    """Squarest (snp_rows, samp_cols) factorization of the device count.

    Returns None when no 2-D layout exists (n_dev prime or < 4) — callers
    fall back to 1-D SNP sharding, which a 1-column grid would only
    re-implement with extra shard_map overhead.
    """
    c = max(d for d in range(1, int(n_dev ** 0.5) + 1) if n_dev % d == 0)
    if c == 1:
        log.warning("--shard-axis grid: %d devices have no 2-D "
                    "factorization; using 1-D SNP sharding", n_dev)
        return None
    return n_dev // c, c


def _progress_logger():
    """Percent/elapsed/ETA logger for :func:`compute_ld_scores` progress."""
    t0 = time.time()

    def cb(done: int, total: int) -> None:
        if done <= 0:
            return
        elapsed = time.time() - t0
        eta = elapsed * (total - done) / done
        log.info("LD pass: %d/%d SNPs (%.0f%%) | elapsed %.1fs | ETA %.1fs",
                 done, total, 100.0 * done / total, elapsed, eta)

    return cb


@elapsed_time
def estimate_lds(
    bfile: str,
    ld_wind: float,
    wind_metric: str,
    maf_thr: float = 1e-5,
    std_thr: float = 1e-5,
    rsq_thr: float | None = None,
    *,
    out: str | None = None,
    extra: bool = False,
    summary: bool = False,
    block_size: int = 512,
    write_m: bool = True,
    streaming: bool | None = None,
    chunk_rows: int = 8192,
    resume_path: str | None = None,
    n_devices: int | None = None,
    shard_samples: bool = False,
    shard_grid: bool = False,
    profile_dir: str | None = None,
    annot: str | None = None,
    use_int8: bool | None = None,
    symmetric: bool | None = None,
    int8_dot_dtype: str = "int8",
    split_missing: bool | None = None,
    progress: bool | None = None,
    bucket_shapes: bool = False,
    verbose: int = 0,  # accepted for reference API drop-in compatibility
):
    """Estimate additive + dominance LD scores from a PLINK bfile.

    API parity with the reference ``estimate_lds``
    (``nldsc/ldscore/routine.py:51-102``); returns a pandas DataFrame when
    ``out`` is None, else writes ``<out>`` TSV (and ``.M``/``.M_5_50``)
    and imports no pandas.

    ``streaming=None`` auto-selects the out-of-core engine when the dense
    working set would exceed :func:`streaming_bytes_limit`; ``resume_path`` enables
    chunk-granular checkpoint/resume (streaming engine only).

    ``n_devices=None`` auto-shards the SNP axis over all local devices when
    more than one is visible (in-core engine); ``shard_samples=True``
    shards the SAMPLE axis instead (per-tile psum of the integer
    S-matrices — the right axis when N, not M, dominates; composes with
    ``streaming`` for the full 2-D M-streamed × N-scattered scale-out);
    ``shard_grid=True`` lays the devices out as a 2-D (snp × samp) mesh —
    in-core the grid engine (halo exchange × sample psums), streaming
    the 3-axis composition (M streamed, chunks round-robined over mesh
    rows, each row sample-sharding its chunk);
    ``profile_dir`` captures a ``jax.profiler`` trace of the compute pass.
    """
    STAGE_TIMES.clear()
    t_parse = time.time()
    ds = PlinkDataset.parse(bfile)
    _stage_add("disk_s", t_parse)

    def _read_raw():
        t0 = time.time()
        raw = ds.bed.read_raw()
        _stage_add("disk_s", t0)
        return raw

    def _read_block():
        t0 = time.time()
        blk = ds.bed.read_block(0, ds.n_snp)
        _stage_add("disk_s", t0)
        return blk

    config = LDConfig(
        ld_wind=ld_wind, wind_metric=wind_metric, maf_thr=maf_thr,
        std_thr=std_thr, rsq_thr=rsq_thr, block_size=block_size,
        use_int8=use_int8, symmetric=symmetric,
        int8_dot_dtype=int8_dot_dtype, split_missing=split_missing,
    ).resolve_rsq(ds.n_snp)

    log.info("Input: %s, size: (M=%d, N=%d)", ds.bed_path, ds.n_snp, ds.n_samples)
    positions = ds.positions(config.wind_metric)

    if streaming is None:
        streaming = (dense_working_bytes(ds.n_snp, ds.n_samples, use_int8)
                     > streaming_bytes_limit())

    from ..core.errors import NLDSCParameterError  # noqa: PLC0415

    avail_dev = jax.devices()
    avail = len(avail_dev)
    if n_devices is not None and n_devices > avail:
        hint = ("adjust XLA_FLAGS=--xla_force_host_platform_device_count"
                if avail_dev[0].platform == "cpu" else
                "make more GPUs visible (CUDA_VISIBLE_DEVICES)")
        raise NLDSCParameterError(
            f"--n-devices {n_devices} exceeds the {avail} visible JAX "
            f"device(s); run with fewer devices or {hint}")
    n_dev = avail if n_devices is None else n_devices
    dev0 = avail_dev[0]
    backend = f"{dev0.platform} {dev0.device_kind}"

    import contextlib
    prof = (jax.profiler.trace(profile_dir) if profile_dir
            else contextlib.nullcontext())
    t0 = time.time()
    with prof:
        if annot is not None:
            from ..io.ldscores import (  # noqa: PLC0415
                make_output_annot, read_annot, write_m_files_annot)

            annot_mat, annot_names = read_annot(annot, ds.bim)
            log.info("Running the LD estimator on %s (partitioned, %d "
                     "annotations%s)...", backend, len(annot_names),
                     ", streaming" if streaming else "")
            if streaming:
                from .streaming import (  # noqa: PLC0415
                    compute_ld_scores_streaming)

                grid_shape = _grid_shape(n_dev) if shard_grid else None
                if grid_shape is not None and n_dev > 1:
                    from ..parallel.grid_sharded import (  # noqa: PLC0415
                        grid_mesh)

                    r, c = grid_shape
                    log.info("Partitioned streaming on a %dx%d "
                             "snp-x-sample GRID", r, c)
                    result = compute_ld_scores_streaming(
                        ds.bed, positions, config, chunk_rows=chunk_rows,
                        resume_path=resume_path, annot=annot_mat,
                        grid=grid_mesh(r, c))
                elif shard_samples and n_dev > 1:
                    from ..parallel import snp_mesh  # noqa: PLC0415

                    log.info("Partitioned streaming on a %d-device "
                             "SAMPLE mesh", n_dev)
                    result = compute_ld_scores_streaming(
                        ds.bed, positions, config, chunk_rows=chunk_rows,
                        resume_path=resume_path, annot=annot_mat,
                        sample_mesh=snp_mesh(n_dev))
                else:
                    devs = avail_dev[:n_dev] if n_dev > 1 else None
                    result = compute_ld_scores_streaming(
                        ds.bed, positions, config, chunk_rows=chunk_rows,
                        resume_path=resume_path, annot=annot_mat,
                        devices=devs)
            else:
                grid_shape = _grid_shape(n_dev) if shard_grid else None
                if n_dev > 1 and grid_shape is not None:
                    from ..parallel.grid_sharded import (  # noqa: PLC0415
                        grid_mesh, ld_scores_grid_sharded)

                    r, c = grid_shape
                    log.info("Partitioned run on a %dx%d snp-x-sample "
                             "GRID mesh", r, c)
                    result = ld_scores_grid_sharded(
                        _read_block(), positions, config,
                        grid_mesh(r, c), annot=annot_mat)
                elif n_dev > 1 and shard_samples:
                    from ..parallel import (  # noqa: PLC0415
                        ld_scores_sample_sharded, snp_mesh)

                    log.info("Partitioned run on a %d-device SAMPLE mesh",
                             n_dev)
                    result = ld_scores_sample_sharded(
                        _read_raw(), positions, config,
                        snp_mesh(n_dev), annot=annot_mat)
                elif n_dev > 1:
                    from ..parallel import (  # noqa: PLC0415
                        ld_scores_sharded, snp_mesh)

                    log.info("Partitioned run on a %d-device SNP mesh",
                             n_dev)
                    result = ld_scores_sharded(
                        _read_raw(), positions, config,
                        snp_mesh(n_dev), annot=annot_mat)
                else:
                    result = compute_ld_scores(
                        _read_raw(), positions, config,
                        annot=annot_mat, bucket_shapes=bucket_shapes)
            dt = time.time() - t0
            log.info("Estimation completed: %d SNPs in %.2fs (%.0f SNPs/s)",
                     ds.n_snp, dt, ds.n_snp / max(dt, 1e-9))
            if summary:
                show_summary(result)
            out_df = make_output_annot(ds.bim, result, annot_names)
            if out:
                t_w = time.time()
                write_l2(out_df, out)
                if write_m:
                    write_m_files_annot(result, annot_mat, annot_names, out)
                _stage_add("write_s", t_w)
                return None
            return out_df.to_pandas()
        if streaming:
            from .streaming import compute_ld_scores_streaming  # noqa: PLC0415

            grid_shape = _grid_shape(n_dev) if shard_grid else None
            if grid_shape is not None and n_dev > 1:
                from ..parallel.grid_sharded import grid_mesh  # noqa: PLC0415

                r, c = grid_shape
                log.info("Running the LD estimator on %s (streaming, "
                         "chunk=%d rows, %dx%d snp-x-sample GRID)...",
                         backend, chunk_rows, r, c)
                result = compute_ld_scores_streaming(
                    ds.bed, positions, config, chunk_rows=chunk_rows,
                    resume_path=resume_path, grid=grid_mesh(r, c))
            elif shard_samples and n_dev > 1:
                from ..parallel import snp_mesh  # noqa: PLC0415

                log.info("Running the LD estimator on %s (streaming, "
                         "chunk=%d rows, %d-device SAMPLE mesh)...",
                         backend, chunk_rows, n_dev)
                result = compute_ld_scores_streaming(
                    ds.bed, positions, config, chunk_rows=chunk_rows,
                    resume_path=resume_path, sample_mesh=snp_mesh(n_dev))
            else:
                devs = avail_dev[:n_dev] if n_dev > 1 else None
                log.info("Running the LD estimator on %s (streaming, "
                         "chunk=%d rows%s)...", backend, chunk_rows,
                         f", {len(devs)} devices" if devs else "")
                result = compute_ld_scores_streaming(
                    ds.bed, positions, config, chunk_rows=chunk_rows,
                    resume_path=resume_path, devices=devs)
        else:
            grid_shape = _grid_shape(n_dev) if shard_grid else None
            if n_dev > 1 and grid_shape is not None:
                from ..parallel.grid_sharded import (  # noqa: PLC0415
                    grid_mesh, ld_scores_grid_sharded)

                r, c = grid_shape
                log.info("Running the LD estimator on %s (%dx%d "
                         "snp-x-sample GRID mesh)...", backend, r, c)
                result = ld_scores_grid_sharded(
                    _read_block(), positions, config,
                    grid_mesh(r, c))
            elif n_dev > 1 and shard_samples:
                from ..parallel import (  # noqa: PLC0415
                    ld_scores_sample_sharded, snp_mesh)

                log.info("Running the LD estimator on %s (%d-device "
                         "SAMPLE mesh)...", backend, n_dev)
                result = ld_scores_sample_sharded(_read_raw(),
                                                  positions, config,
                                                  snp_mesh(n_dev))
            elif n_dev > 1:
                from ..parallel import ld_scores_sharded, snp_mesh  # noqa: PLC0415

                log.info("Running the LD estimator on %s (%d-device SNP "
                         "mesh)...", backend, n_dev)
                result = ld_scores_sharded(_read_raw(), positions,
                                           config, snp_mesh(n_dev))
            else:
                # device-decode ingestion: ship the packed 2-bit rows (4x
                # less transfer) and unpack on the accelerator
                genotypes = _read_raw()
                log.info("Running the LD estimator on %s...", backend)
                # percent/ETA ticks by default for big runs (segmented
                # dispatch costs one host sync per tick)
                want_prog = (progress if progress is not None
                             else ds.n_snp >= 20000)
                cb = _progress_logger() if want_prog else None
                result = compute_ld_scores(genotypes, positions, config,
                                           progress=cb,
                                           bucket_shapes=bucket_shapes)
    dt = time.time() - t0
    log.info("Estimation completed: %d SNPs in %.2fs (%.0f SNPs/s)",
             ds.n_snp, dt, ds.n_snp / max(dt, 1e-9))
    if STAGE_TIMES:
        log.info("Stage decomposition: %s",
                 {k: round(v, 2) for k, v in sorted(STAGE_TIMES.items())})

    if summary:
        show_summary(result)

    out_df = make_output(ds.bim, result, extra=extra)
    if out:
        t_w = time.time()
        write_l2(out_df, out)
        if write_m:
            write_m_files(result, out)
        _stage_add("write_s", t_w)
        return None
    return out_df.to_pandas()
