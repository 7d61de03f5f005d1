"""A run's command line, its refusal without a card or without the port,
the check for JAX, the result line's schema, and a sound tiny run of
every cell coming out correct."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness, registry
from portbench.run import forbidden_modules
from portbench.tests import tiny

ROOT = registry.HERE.parent
CELLS = tiny.CELLS


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules(["music_tpu_torch", "music_tpu_torch.kernels", "torch"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.core", "music_tpu.models",
                              "music_tpu_torch"]) == ["flax", "jax", "jaxlib", "music_tpu"]
    assert forbidden_modules(["jaxtyping", "music_tpu_tools"]) == []


def _cpu_only() -> bool:
    import torch

    return not torch.cuda.is_available()


def test_no_card_no_result():
    if not _cpu_only():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's folder
    (no port), the run fails and prints nothing."""
    shutil.copytree(registry.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _schema(r: dict, spec: dict, traced: bool):
    assert list(r)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in r
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = spec["per_layer"] if traced else spec["end_to_end"]
    units = {m["name"]: m["unit"] for m in want}
    assert set(r["metrics"]) <= set(units)
    for name, v in r["metrics"].items():
        assert v["unit"] == units[name] and isinstance(v["value"], float)
    for name, c in r["checks"].items():
        assert set(c) == {"value", "limit"}
    if traced:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert len(r["breakdown"]["device_ops"]) <= 10 >= len(r["breakdown"]["idle_gaps"])
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_and_well_formed(cell):
    spec = tiny.cell(cell)
    r = harness.run_cell(spec, 2**31 + 11, 1.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["numbers"].get("clips_checked", 1) > 0
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"setup_s"} < set(r["metrics"])
    _schema(r, spec, False)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_is_well_formed(cell):
    spec = tiny.cell(cell)
    r = harness.run_cell(spec, 5, 0.5, True, "cpu")
    _schema(r, spec, True)
    assert r["metrics"], "a traced run reports per-layer metrics"
