#!/usr/bin/env python3
"""Drive ``ld`` and ``h2`` end to end on a GPU at a realistic size, and check
every result against the float64 oracle or against another route.

    python chip_smoke.py               # one GPU: the phases below
    python chip_smoke.py --four-cards  # four GPUs: the multi-device routes

Data: seeded PLINK bfiles from the LD-block generator of ``tests/utils.py``,
M = 65,536 SNPs x N = 16,384 samples at a uniform 100 bp spacing, run with
``-kb 100`` (+-1000 SNPs): a chromosome segment at a sample count between a
reference panel and a biobank.  Everything runs in this one process (a JAX
process reserves most of the card, so a second one could not start); the CLI
is driven through its own entry function with an argv list.

One-GPU phases, in order: ``ld_clean`` (int8 symmetric engine, packed
ingestion), ``dot_dtype`` (warm int8 vs bf16 contraction times and the
kernels a profiler trace shows), ``ld_rowmiss`` (split-missing engine),
``ld_entrymiss`` (global 8-matmul epilogue), ``ld_annot`` (partitioned LD with
split corrections), ``ld_stream`` (streaming driver), ``h2`` (host f64) and
``h2_on_device`` (f32 on the card).  LD phases are compared with the oracle on
256 interior rows of a 4,096-row slice at the golden tolerance; integer
counters must be exact.

The script exits non-zero, printing no result, when JAX finds no GPU or any
check fails.  Its last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
TRACES = os.path.join(WORK, "traces")

M, N = 65_536, 16_384
SPACING_BP = 100
WINDOW_KB = 100.0
MAF = 0.01
STD = 1e-4                  # the CLI's -std default
RTOL, ATOL = 2e-5, 2e-4     # tests/test_golden.py
SLICE, N_ROWS = 4096, 256   # oracle slice and sampled interior rows
# Two f32 engines may count a dominance pair on opposite sides of rsq_thr
# when its adjusted r² lies within their rounding of the threshold (at
# this shape about one pair in 1e8).  Where two routes' WSDE differ, the
# float64 oracle decides, up to the pairs within WSE_MARGIN of rsq_thr.
WSE_MARGIN = 1e-8
N_ANNOT = 8
H2_TRUE, N_GWAS = 0.3, 50_000.0
SEED = 2026


def die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


class Run:
    """Shared state: failed checks, compile time, captured log lines."""

    def __init__(self):
        import jax

        from nldsc_jax.core.logging import log

        self.failed: list[str] = []
        self.compile_s = 0.0
        self.log: list[str] = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        handler = logging.Handler()
        handler.emit = lambda rec: self.log.append(rec.getMessage())
        log.addHandler(handler)

    def _on_event(self, event: str, secs: float, **_) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += secs

    def check(self, phase: str, ok: bool, line: str) -> None:
        print(f"{phase}: {'ok' if ok else 'FAILED'} {line}")
        if not ok:
            self.failed.append(phase)

    def logged(self, text: str, since: int) -> bool:
        return any(text in msg for msg in self.log[since:])


def cli(argv: list[str]) -> None:
    from nldsc_jax.cli import main

    code = main(argv)
    if code != 0:
        die(f"CLI exited {code}: {' '.join(argv)}")


# ---------------------------------------------------------------- data

def make_data(rng, with_entrymiss: bool) -> dict:
    """Clean, row-missing and (optionally) entry-missing bfiles."""
    from nldsc_jax.io.plink import write_plink
    from utils import random_genotypes

    t0 = time.time()
    bp = np.arange(1, M + 1, dtype=np.int64) * SPACING_BP
    g = random_genotypes(rng, M, N, missing_rate=0.0)
    data = {"bp": bp, "g": {}, "prefix": {}}

    def add(name, codes):
        data["g"][name] = codes
        data["prefix"][name] = write_plink(os.path.join(WORK, name), codes,
                                           bp=bp)

    add("clean", g)
    # 5% missing in 2% of the rows
    rows = np.sort(rng.choice(M, size=M // 50, replace=False))
    g_row = g.copy()
    g_row[rows] = np.where(rng.random((rows.size, N)) < 0.05, np.int8(-1),
                           g[rows])
    add("rowmiss", g_row)
    if with_entrymiss:
        # 2% missing in every row
        g_ent = g.copy()
        for s in range(0, M, 4096):
            blk = g_ent[s:s + 4096]
            blk[rng.random(blk.shape, dtype=np.float32) < 0.02] = -1
        add("entrymiss", g_ent)
    print(f"data: M={M} N={N} spacing={SPACING_BP}bp window=+-{WINDOW_KB}kb "
          f"bfiles={sorted(data['prefix'])} in {time.time() - t0:.1f}s")
    return data


# ------------------------------------------------------------ comparisons

def _close(got: np.ndarray, want: np.ndarray, rtol=RTOL, atol=ATOL):
    """(within tolerance, max abs err, max rel err), NaN == NaN."""
    both_nan = np.isnan(got) & np.isnan(want)
    diff = np.where(both_nan, 0.0, np.abs(got - want))
    diff = np.where(np.isnan(diff), np.inf, diff)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(diff == 0, 0.0, diff / np.abs(want))
    ok = bool((diff <= atol + rtol * np.abs(np.nan_to_num(want))).all())
    return ok, float(diff.max(initial=0.0)), float(np.nanmax(rel, initial=0))


def oracle_slice(data: dict, name: str, rng):
    """Slice start, sampled global rows, and the slice's genotypes and
    positions: every sampled row's window lies inside the slice."""
    half = int(WINDOW_KB * 1000 // SPACING_BP)
    s0 = M // 2 - SLICE // 2
    rows = np.sort(rng.choice(np.arange(s0 + half, s0 + SLICE - half),
                              size=N_ROWS, replace=False))
    return (s0, rows, data["g"][name][s0:s0 + SLICE],
            data["bp"][s0:s0 + SLICE].astype(np.float64))


PRECISION = ("int8 x int8 -> int32 engine dots (exact); f32 annot dots "
             "precision=HIGHEST")


def check_ld(run: Run, phase: str, l2_path: str, data: dict, name: str,
             rng) -> None:
    from nldsc_jax.io.table import read_table
    from nldsc_jax.ld.oracle import oracle_ld

    t0 = time.time()
    s0, rows, g, pos = oracle_slice(data, name, rng)
    ora = oracle_ld(g, pos, WINDOW_KB * 1000, MAF, STD, 1.0 / M,
                    rows=rows - s0)
    tab = read_table(l2_path, sep="\t")
    ok_all, parts = True, []
    for col, key in (("L2", "l2"), ("L2D", "l2d")):
        ok, ab, rel = _close(np.asarray(tab[col][rows], np.float64),
                             ora[key][rows - s0])
        ok_all &= ok
        parts.append(f"{col} max_abs={ab:.3e} max_rel={rel:.3e}")
    for col, key in (("WSA", "l2_ws"), ("WSD", "l2d_ws"),
                     ("WSDE", "l2d_wse")):
        bad = int((tab[col][rows] != ora[key][rows - s0]).sum())
        ok_all &= bad == 0
        parts.append(f"{col} mismatches={bad}")
    run.check(phase, ok_all,
              f"rows={N_ROWS} {' '.join(parts)} tol=rtol {RTOL} atol {ATOL}"
              f" counters exact; {PRECISION}; oracle {time.time() - t0:.1f}s")


def check_ld_annot(run: Run, l2_path: str, annot: np.ndarray, names,
                   data: dict, rng) -> None:
    from nldsc_jax.io.table import read_table
    from nldsc_jax.ld.oracle import oracle_ld_annot

    s0, rows, g, pos = oracle_slice(data, "rowmiss", rng)
    ora = oracle_ld_annot(g, pos, WINDOW_KB * 1000, MAF, STD,
                          annot[s0:s0 + SLICE], rows=rows - s0)
    tab = read_table(l2_path, sep="\t")
    ok_all, worst = True, {"L2": (0.0, 0.0), "L2D": (0.0, 0.0)}
    for suffix, key in (("L2", "l2_annot"), ("L2D", "l2d_annot")):
        for k, nm in enumerate(names):
            ok, ab, rel = _close(
                np.asarray(tab[f"{nm}.{suffix}"][rows], np.float64),
                ora[key][rows - s0, k])
            ok_all &= ok
            worst[suffix] = (max(worst[suffix][0], ab),
                             max(worst[suffix][1], rel))
    run.check("ld_annot", ok_all,
              f"rows={N_ROWS} p={len(names)} "
              + " ".join(f"{s} max_abs={a:.3e} max_rel={r:.3e}"
                         for s, (a, r) in worst.items())
              + f" tol=rtol {RTOL} atol {ATOL}; {PRECISION}")


def oracle_wse(data: dict, name: str, row: int) -> tuple[int, int]:
    """Float64 WSDE of one global row, and how many of its dominance
    pairs have an adjusted r² within WSE_MARGIN of rsq_thr."""
    from nldsc_jax.ld.oracle import preprocess

    half = int(WINDOW_KB * 1000 // SPACING_BP)
    s0, s1 = max(0, row - half), min(M, row + half + 1)
    pos = data["bp"][s0:s1].astype(np.float64)
    pre = preprocess(data["g"][name][s0:s1], pos, MAF)
    i = row - s0
    nbr = (np.abs(pos - pos[i]) <= WINDOW_KB * 1000) & pre.usable
    nbr[i] = False
    dom = nbr & (pre.residuals_sd > STD)
    r = pre.res_std[dom] @ pre.add_std[i] / N
    adj = 1.0 - (1.0 - r * r) * (N - 1) / (N - 2)
    thr = 1.0 / M
    return int((adj > thr).sum()), int((np.abs(adj - thr) < WSE_MARGIN).sum())


def compare_counters(a: dict, b: dict, data: dict, name: str) -> tuple:
    """(ok, description) for ``b``'s window counters against ``a``'s:
    WSA and WSD exact; WSDE exact, or where the two differ, ``b`` within
    the near-threshold pairs of the float64 oracle."""
    ok = all(np.array_equal(a[k], b[k]) for k in ("l2_ws", "l2d_ws"))
    parts = [f"WSA/WSD exact={ok}"]
    rows = np.flatnonzero(np.asarray(a["l2d_wse"]) != np.asarray(b["l2d_wse"]))
    for row in rows[:8]:
        truth, near = oracle_wse(data, name, int(row))
        fine = abs(int(b["l2d_wse"][row]) - truth) <= near
        ok &= fine
        parts.append(f"WSDE row {row}: {int(a['l2d_wse'][row])} vs "
                     f"{int(b['l2d_wse'][row])}, f64 oracle {truth} with "
                     f"{near} pair(s) within {WSE_MARGIN:g} of rsq_thr")
    ok &= rows.size <= 8
    parts.append(f"WSDE rows differing={rows.size}")
    return ok, " ".join(parts)


def check_same_ld(run: Run, phase: str, path_a: str, path_b: str,
                  data: dict) -> None:
    from nldsc_jax.io.table import read_table

    a, b = read_table(path_a, sep="\t"), read_table(path_b, sep="\t")
    ok_all, parts = True, []
    for col in ("L2", "L2D"):
        ok, ab, rel = _close(np.asarray(b[col], np.float64),
                             np.asarray(a[col], np.float64))
        ok_all &= ok
        parts.append(f"{col} max_abs={ab:.3e} max_rel={rel:.3e}")
    ok, desc = compare_counters(
        *({"l2_ws": t["WSA"], "l2d_ws": t["WSD"], "l2d_wse": t["WSDE"]}
          for t in (a, b)), data, "clean")
    run.check(phase, ok_all and ok, f"rows={M} vs ld_clean "
              f"{' '.join(parts)} tol=rtol {RTOL} atol {ATOL}; {desc}")


# ----------------------------------------------------------------- phases

def ld_phase(run: Run, phase: str, prefix: str, *extra: str,
             route: str | None = None, absent: str | None = None) -> str:
    out = os.path.join(WORK, f"{phase}.L2")
    since, c0, t0 = len(run.log), run.compile_s, time.time()
    cli(["ld", "--bfile", prefix, "-kb", str(WINDOW_KB), "-maf", str(MAF),
         "--extra", "-o", out, "--display", *extra])
    from nldsc_jax.core.timing import STAGE_TIMES

    stages = {k: round(v, 3) for k, v in sorted(STAGE_TIMES.items())}
    print(f"{phase}: CLI wall {time.time() - t0:.2f}s, backend compile "
          f"{run.compile_s - c0:.2f}s, stages {stages}")
    if not run.logged("Running the LD estimator on gpu", since):
        run.check(phase, False, "the LD log does not name the gpu backend")
    if route is not None and not run.logged(route, since):
        run.check(phase, False, f"route log {route!r} missing")
    if absent is not None and run.logged(absent, since):
        run.check(phase, False, f"unexpected route log {absent!r}")
    return out


def top_device_events(trace_dir: str, k: int = 3) -> dict[str, list]:
    """Largest device-time totals by event name, per profiler line kind:
    GPU kernels (stream lines) and XLA ops."""
    import jax

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    prof = jax.profiler.ProfileData.from_file(files[-1])
    totals: dict[str, dict[str, int]] = {"kernels": {}, "ops": {}}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            kind = ("kernels" if line.name.startswith("Stream") else
                    "ops" if line.name == "XLA Ops" else None)
            if kind is None:
                continue
            for ev in line.events:
                totals[kind][ev.name] = (totals[kind].get(ev.name, 0)
                                         + ev.duration_ns)
    return {kind: sorted(t.items(), key=lambda kv: -kv[1])[:k]
            for kind, t in totals.items()}


def dot_dtype_phase(run: Run, prefix: str) -> None:
    """Warm device pass of ld_clean with each contraction dtype."""
    import jax

    from nldsc_jax.config import LDConfig
    from nldsc_jax.core.timing import STAGE_TIMES
    from nldsc_jax.io.plink import PlinkDataset
    from nldsc_jax.ld.pipeline import compute_ld_scores

    ds = PlinkDataset.parse(prefix)
    packed = ds.bed.read_raw()
    positions = ds.positions("bp")
    results = {}
    for dtype in ("int8", "bf16"):
        cfg = LDConfig(ld_wind=WINDOW_KB, wind_metric="kbp", maf_thr=MAF,
                       std_thr=STD, int8_dot_dtype=dtype).resolve_rsq(M)
        c0 = run.compile_s
        results[dtype] = compute_ld_scores(packed, positions, cfg)
        compile_s = run.compile_s - c0
        walls, devs = [], []
        for _ in range(3):
            STAGE_TIMES.clear()
            t0 = time.perf_counter()
            compute_ld_scores(packed, positions, cfg)
            walls.append(time.perf_counter() - t0)
            devs.append(STAGE_TIMES["device_s"])
        trace_dir = os.path.join(TRACES, dtype)
        shutil.rmtree(trace_dir, ignore_errors=True)
        with jax.profiler.trace(trace_dir):
            compute_ld_scores(packed, positions, cfg)
        top = top_device_events(trace_dir)
        print(f"dot_dtype {dtype}: warm device pass median "
              f"{np.median(devs):.4f}s (runs {[round(d, 4) for d in devs]}),"
              f" wall incl. transfer median {np.median(walls):.4f}s, "
              f"compile {compile_s:.2f}s")
        for kind, rows in top.items():
            for name, ns in rows:
                print(f"dot_dtype {dtype} top {kind}: {ns / 1e6:9.3f} ms "
                      f"{name[:110]}")
    same = all(np.array_equal(results["int8"][k], results["bf16"][k],
                              equal_nan=True) for k in results["int8"])
    run.check("dot_dtype", same, "int8 and bf16 results bitwise equal")


def write_annot(data: dict, rng) -> tuple[str, np.ndarray, list[str]]:
    """p = 8 seeded annotations: 4 binary, 4 continuous."""
    from nldsc_jax.io.table import Table, write_table

    cols = [rng.random(M) < q for q in (0.1, 0.2, 0.3, 0.4)]
    cols += [rng.normal(size=M), rng.uniform(0, 2, M),
             rng.lognormal(0.0, 0.5, M), rng.exponential(1.0, M)]
    annot = np.column_stack(cols).astype(np.float64)
    names = [f"a{k}" for k in range(N_ANNOT)]
    path = os.path.join(WORK, "smoke.annot")
    table = {"SNP": np.array([f"rs{i + 1}" for i in range(M)], dtype=object)}
    table.update({nm: annot[:, k] for k, nm in enumerate(names)})
    write_table(Table(table), path, float_format="%.17g")
    return path, annot, names


def h2_phase(run: Run, l2_path: str, rng) -> tuple[dict, str, str]:
    from nldsc_jax.io.ldscores import read_m
    from nldsc_jax.io.table import Table, read_table, write_table

    tab = read_table(l2_path, sep="\t")
    m_count, _ = read_m(os.path.splitext(l2_path)[0] + ".M_5_50")
    l2 = np.asarray(tab["L2"], np.float64)
    ok = np.isfinite(l2)
    var = 1.0 + N_GWAS * H2_TRUE * l2[ok] / m_count
    ss = os.path.join(WORK, "smoke.sumstats")
    write_table(Table({"SNP": tab["SNP"][ok],
                       "Z": rng.normal(size=ok.sum()) * np.sqrt(var),
                       "N": np.full(ok.sum(), N_GWAS)}), ss,
                float_format="%.9g")
    out = os.path.join(WORK, "h2.json")
    t0 = time.time()
    cli(["h2", "--sumstats", ss, "--ref-ld", l2_path, "--w-ld", l2_path,
         "-s", out, "--display"])
    with open(out) as f:
        summary = json.load(f)
    add = summary["additive"]
    hsq, se = add["hsq"], add["hsq.std"]
    fine = bool(np.isfinite(hsq) and np.isfinite(se)
                and abs(hsq - H2_TRUE) <= 3 * se)
    run.check("h2", fine, f"hsq={hsq:.5f} se={se:.5f} true={H2_TRUE} "
              f"(|hsq-true| <= 3 se) M_5_50={m_count} "
              f"snps={int(ok.sum())} wall {time.time() - t0:.2f}s host f64")
    return summary, ss, l2_path


def h2_on_device_phase(run: Run, host: dict, ss: str, l2_path: str) -> None:
    out = os.path.join(WORK, "h2_on_device.json")
    t0, c0 = time.time(), run.compile_s
    cli(["h2", "--sumstats", ss, "--ref-ld", l2_path, "--w-ld", l2_path,
         "-s", out, "--on-device", "--display"])
    with open(out) as f:
        dev = json.load(f)
    ok_all, worst = True, 0.0
    for part in ("additive", "dominant"):
        for key, val in host[part].items():
            mine = dev[part][key]
            if isinstance(val, bool):
                ok_all &= mine == val
                continue
            ok, _, rel = _close(np.float64(mine), np.float64(val),
                                rtol=2e-5, atol=1e-6)
            ok_all &= ok
            worst = max(worst, rel)
    run.check("h2_on_device", ok_all,
              f"hsq={dev['additive']['hsq']:.5f} max_rel vs h2={worst:.3e} "
              f"tol=rtol 2e-5 atol 1e-6; f32, matmul precision HIGHEST; "
              f"wall {time.time() - t0:.2f}s compile "
              f"{run.compile_s - c0:.2f}s")


def one_card(run: Run) -> None:
    rng = np.random.default_rng(SEED)
    data = make_data(rng, with_entrymiss=True)
    c0, t0 = run.compile_s, time.time()
    clean = ld_phase(run, "ld_clean", data["prefix"]["clean"],
                     absent="Split-missing engine")
    print(f"compile: ld_clean cold backend compile {run.compile_s - c0:.2f}s"
          f" of {time.time() - t0:.2f}s wall")
    check_ld(run, "ld_clean", clean, data, "clean", rng)
    dot_dtype_phase(run, data["prefix"]["clean"])
    rowmiss = ld_phase(run, "ld_rowmiss", data["prefix"]["rowmiss"],
                       route="Split-missing engine")
    check_ld(run, "ld_rowmiss", rowmiss, data, "rowmiss", rng)
    entry = ld_phase(run, "ld_entrymiss", data["prefix"]["entrymiss"],
                     absent="Split-missing engine")
    check_ld(run, "ld_entrymiss", entry, data, "entrymiss", rng)
    annot_path, annot, names = write_annot(data, rng)
    annot_out = ld_phase(run, "ld_annot", data["prefix"]["rowmiss"],
                         "--annot", annot_path,
                         route="Split-missing engine")
    check_ld_annot(run, annot_out, annot, names, data, rng)
    stream = ld_phase(run, "ld_stream", data["prefix"]["clean"],
                      "--streaming", "--chunk-rows", "8192",
                      route="streaming")
    check_same_ld(run, "ld_stream", clean, stream, data)
    host, ss, l2_path = h2_phase(run, clean, rng)
    h2_on_device_phase(run, host, ss, l2_path)


# -------------------------------------------------------------- four cards

def four_cards(run: Run) -> None:
    """Each multi-device route against the same input on one card."""
    import jax

    from nldsc_jax.config import LDConfig
    from nldsc_jax.io.plink import PlinkDataset
    from nldsc_jax.ld.pipeline import compute_ld_scores
    from nldsc_jax.ld.streaming import compute_ld_scores_streaming
    from nldsc_jax.parallel import (ld_scores_sample_sharded,
                                    ld_scores_sharded, snp_mesh)
    from nldsc_jax.parallel.grid_sharded import (grid_mesh,
                                                 ld_scores_grid_sharded)

    devs = jax.devices()
    if len(devs) < 4:
        die(f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")
    devs = devs[:4]
    data = make_data(np.random.default_rng(SEED), with_entrymiss=False)
    cfg = LDConfig(ld_wind=WINDOW_KB, wind_metric="kbp", maf_thr=MAF,
                   std_thr=STD).resolve_rsq(M)

    def allocs():
        return [(d.memory_stats() or {}).get("num_allocs", 0) for d in devs]

    for name, prefix in data["prefix"].items():
        ds = PlinkDataset.parse(prefix)
        pos = ds.positions("bp")
        raw, block = ds.bed.read_raw(), ds.bed.read_all()
        routes = {
            "snp_mesh": lambda k: ld_scores_sharded(raw, pos, cfg,
                                                    snp_mesh(k)),
            "sample_mesh": lambda k: ld_scores_sample_sharded(
                raw, pos, cfg, snp_mesh(k)),
            "grid_2x2": lambda k: ld_scores_grid_sharded(
                block, pos, cfg, grid_mesh(2, 2)),
            "stream_round_robin": lambda k: compute_ld_scores_streaming(
                ds.bed, pos, cfg, chunk_rows=8192,
                devices=devs[:k] if k > 1 else None),
            "stream_grid_2x2": lambda k: compute_ld_scores_streaming(
                ds.bed, pos, cfg, chunk_rows=8192, grid=grid_mesh(2, 2)),
        }
        # routes whose one-card form exists are compared with it bitwise
        # (parallel/mesh.py: l2/l2d invariant in the device count); every
        # route is also compared with the one-card dense engine, whose f32
        # sums may differ in the last ulps at band-clamp boundaries, at
        # the golden tolerance
        one_card_form = {"snp_mesh", "sample_mesh", "stream_round_robin"}
        dense = compute_ld_scores(raw, pos, cfg, device=devs[0])
        for route, fn in routes.items():
            a0, t0, c0 = allocs(), time.time(), run.compile_s
            res = fn(4)
            wall, comp = time.time() - t0, run.compile_s - c0
            touched = sum(b > a for a, b in zip(a0, allocs()))
            counters, desc = compare_counters(dense, res, data, name)
            ok = touched == 4 and counters
            parts = [f"cards touched={touched}/4",
                     f"counters vs 1-card dense: {desc}"]
            if route in one_card_form:
                ref = fn(1)
                bitwise = all(np.array_equal(res[k], ref[k], equal_nan=True)
                              for k in ("l2", "l2d"))
                ok &= bitwise
                parts.append(f"l2/l2d bitwise vs same route on 1 card="
                             f"{bitwise}")
            for k in ("l2", "l2d"):
                good, ab, rel = _close(res[k], dense[k])
                ok &= good
                parts.append(f"{k} vs 1-card dense max_abs={ab:.3e} "
                             f"max_rel={rel:.3e}")
            run.check(f"four_cards[{name}] {route}", ok,
                      " ".join(parts) + f" tol=rtol {RTOL} atol {ATOL}; wall "
                      f"{wall:.2f}s compile {comp:.2f}s")
    peaks = [round((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                   / 2**30, 2) for d in devs]
    print(f"four_cards: peak GiB in use per card {peaks}")


# ------------------------------------------------------------------ main

def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the multi-device routes on 4 GPUs")
    args = parser.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "nldsc_jax")):
        die("run from a checkout of the repository (nldsc_jax/ not found)")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax

    if jax.default_backend() != "gpu":
        die(f"no GPU: JAX's default backend is {jax.default_backend()!r}")
    import nldsc_jax  # noqa: F401  (sets up the compile cache)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for line in smi:
        print(line)
    dev = jax.devices()[0]
    print(f"jax {jax.__version__}; devices {len(jax.devices())} x "
          f"{dev.device_kind}; compile cache "
          f"{jax.config.jax_compilation_cache_dir or 'off'}")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    run = Run()
    t0 = time.time()
    try:
        four_cards(run) if args.four_cards else one_card(run)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"total: {time.time() - t0:.1f}s, backend compile "
          f"{run.compile_s:.1f}s")
    if run.failed:
        die(f"failed checks: {run.failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
