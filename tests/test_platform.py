"""Device-facing plumbing that the CPU can check: where the compile cache
lives, the auto-streaming limit, matmul precision on the LD path, the
CLI's crash reporting, and what the main path imports."""

import logging
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax import lax

from nldsc_jax.config import LDConfig
from nldsc_jax.core import compile_cache
from nldsc_jax.core.logging import log
from nldsc_jax.ld import ld_int8, ld_split, pipeline
from utils import make_positions, random_genotypes, run_cli

REPO = Path(__file__).resolve().parents[1]


def _record_config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    return calls


def test_cache_env_dir_sets_no_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("NLDSC_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_config_updates(monkeypatch)
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    assert calls == []


def test_cache_default_dir_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("NLDSC_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config_updates(monkeypatch)
    first = compile_cache.enable_persistent_cache()
    second = compile_cache.enable_persistent_cache()
    assert first == second == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", first)] * 2


def test_streaming_limit_from_memory_stats():
    def dev(platform, stats):
        return SimpleNamespace(platform=platform, device_kind="fake",
                               memory_stats=lambda: stats)

    limit = 60 << 30
    assert pipeline.streaming_bytes_limit(
        dev("gpu", {"bytes_limit": limit})) == limit // 2
    assert (pipeline.streaming_bytes_limit(dev("cpu", None))
            == pipeline.CPU_STREAMING_BYTES)
    with pytest.raises(RuntimeError, match="bytes_limit"):
        pipeline.streaming_bytes_limit(dev("gpu", {}))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        pipeline.streaming_bytes_limit(dev("gpu", None))


def _f32_dots(jaxpr):
    """(precision, algorithm) of every dot_general on f32 operands,
    sub-jaxprs (jit, scan, cond bodies) included."""
    found = []
    for eqn in jaxpr.eqns:
        if (eqn.primitive.name == "dot_general"
                and any(v.aval.dtype == np.float32 for v in eqn.invars)):
            found.append((eqn.params.get("precision"),
                          eqn.params.get("preferred_element_type")))
        for val in eqn.params.values():
            for sub in (val if isinstance(val, (list, tuple)) else [val]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found.extend(_f32_dots(inner))
    return found


@pytest.mark.parametrize("target", ["sym_scan", "split_corrections"])
def test_annot_contractions_run_at_highest(monkeypatch, target):
    """The annot contractions of the symmetric scan and of the split
    corrections ask for full f32 precision: a GPU's default f32 matmul is
    TF32 (~3 decimal digits)."""
    module, name = {"sym_scan": (ld_int8, "sym_scan_segment"),
                    "split_corrections": (ld_split, "split_corrections")
                    }[target]
    orig = getattr(module, name)
    jaxprs = []

    def spy(*args, **kw):
        jaxprs.append(jax.make_jaxpr(lambda *a: orig(*a, **kw))(*args))
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    rng = np.random.default_rng(7)
    m, n = 256, 96
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    g[rng.choice(m, 8, replace=False), :5] = -1   # a few contaminated rows
    pos = make_positions(m, spacing=500)
    annot = np.column_stack([np.ones(m), rng.uniform(0, 2, m)])
    cfg = LDConfig(ld_wind=8000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=1e-3, block_size=32)
    pipeline.compute_ld_scores(g, pos, cfg, annot=annot)
    assert jaxprs, f"{name} was not called"
    dots = [d for jp in jaxprs for d in _f32_dots(jp.jaxpr)]
    assert dots, "no f32 contraction found"
    highest = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
    assert all(prec == highest for prec, _ in dots), dots


def _write_toy(tmp_path, rng):
    from nldsc_jax.io.plink import write_plink

    g = random_genotypes(rng, 300, 120, missing_rate=0.02)
    bp = make_positions(300, spacing=500).astype(np.int64)
    return write_plink(tmp_path / "toy", g, bp=bp)


@pytest.fixture()
def crash_lines():
    lines = []
    handler = logging.Handler(logging.CRITICAL)
    handler.setFormatter(logging.Formatter("[%(levelname).1s] %(message)s"))
    handler.emit = lambda rec: lines.append(handler.format(rec))
    log.addHandler(handler)
    yield lines
    log.removeHandler(handler)


@pytest.mark.parametrize("probe", ["kb_and_cm", "missing_bfile",
                                   "cm_window_bound", "missing_w_ld",
                                   "json_overwrite"])
def test_cli_error_probes(probe, tmp_path, crash_lines):
    prefix = str(tmp_path / "absent")
    if probe in ("kb_and_cm", "cm_window_bound", "missing_w_ld",
                 "json_overwrite"):
        prefix = _write_toy(tmp_path, np.random.default_rng(3))
    if probe in ("missing_w_ld", "json_overwrite"):
        l2 = str(tmp_path / "toy.L2")
        assert run_cli(["ld", "--bfile", prefix, "-kb", "20", "-o", l2,
                        "--block-size", "32"]).exit_code == 0
        ss = tmp_path / "toy.sumstats"
        ss.write_text("SNP\tZ\tN\n" + "".join(
            f"rs{i + 1}\t{np.sin(i):.4f}\t5000\n" for i in range(300)))
        json_path = tmp_path / "h2.json"
        json_path.write_text("{}")
    argv = {
        "kb_and_cm": ["ld", "--bfile", prefix, "-kb", "5", "-cm", "1"],
        "missing_bfile": ["ld", "--bfile", prefix, "-kb", "5"],
        "cm_window_bound": ["ld", "--bfile", prefix, "-cm", "500"],
        "missing_w_ld": ["h2", "--sumstats", str(tmp_path / "toy.sumstats"),
                         "--ref-ld", str(tmp_path / "toy.L2"),
                         "--w-ld", str(tmp_path / "other.L2")],
        "json_overwrite": ["h2", "--sumstats",
                           str(tmp_path / "toy.sumstats"),
                           "--ref-ld", str(tmp_path / "toy.L2"),
                           "--w-ld", str(tmp_path / "toy.L2"),
                           "--n-blocks", "10",
                           "-s", str(tmp_path / "h2.json")],
    }[probe]
    assert run_cli(argv).exit_code == 1
    assert len(crash_lines) == 1
    assert crash_lines[0].startswith("[C] The program crashed with ")


def test_main_path_imports_no_pandas_or_click(tmp_path):
    prefix = _write_toy(tmp_path, np.random.default_rng(5))
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from nldsc_jax.cli import main
d = {str(tmp_path)!r}
assert main(["ld", "--bfile", {prefix!r}, "-kb", "20", "--extra",
             "-o", d + "/toy.L2", "--block-size", "32"]) == 0
assert main(["ld-genome", "--bfiles", {prefix!r}, "--out-dir", d + "/g",
             "-kb", "20"]) == 0
lines = open(d + "/toy.L2").read().splitlines()[1:]
with open(d + "/toy.sumstats", "w") as f:
    f.write("SNP Z N\\n")
    for i, ln in enumerate(lines):
        f.write(ln.split("\\t")[1] + " %.3f 5000\\n" % ((i % 7) - 3))
assert main(["h2", "--sumstats", d + "/toy.sumstats", "--ref-ld",
             d + "/toy.L2", "--w-ld", d + "/toy.L2", "--n-blocks", "10"]) == 0
print("IMPORTED", "pandas" in sys.modules, "click" in sys.modules)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPORTED False False" in out.stdout


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr
