"""The benchmark finds every cell, configuration, mix, limit and metric by
name, keeps to its schema, and takes a new one as files and
entries alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import registry

ROOT = registry.HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    spec = registry.cell(cell)
    kind = {"serve": "Server", "train": "Trainer"}[spec["traffic"]["kind"]]
    assert getattr(registry.family(spec["config"]), kind)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"
    for m in spec["per_layer"]:
        assert callable(registry.reader(m["name"]))
        assert m["moves"] in names
    assert spec["limits"], "every cell has limits for its check"


def test_benchmark_keeps_to_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert configs == used
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells)) and m["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"] + BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(m["name"])
        assert m.get("better", "lower") in ("lower", "higher")
        assert UNIT.match(m.get("unit", "x"))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_new_cell_is_files_and_entries_only(tmp_path):
    """A new configuration, mix, cell, limits and per-layer metric: new
    files under the folder and new entries in BENCHMARK.json, no edit."""
    shutil.copytree(registry.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "wavenet.json").read_text())
    cfg["model"]["dilations"] = cfg["model"]["dilations"][:20]
    (pb / "configs" / "wavenet_half.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "serve.json").read_text())
    mix["clients"] = 132
    (pb / "traffic" / "serve_small.json").write_text(json.dumps(mix))
    (pb / "limits" / "wavenet_half.serve_small.json").write_text('{"max_logit_gap": 1.0}')
    (pb / "metrics" / "clips_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx['stats']['latency']))\n")
    bench["configs"].append({"name": "wavenet_half", "source": "x", "reduced": [],
                             "file": "portbench/configs/wavenet_half.json", "why": "x"})
    bench["workloads"].append({"name": "wavenet_half.serve_small", "config": "wavenet_half",
                               "traffic": "serve_small", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "clips_done.serve", "unit": "clips", "better": "higher",
                               "source": "host_clock", "layer": "session", "moves": "clip_p95_s",
                               "workloads": ["wavenet_half.serve_small"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "wavenet.serve" in m["workloads"]:
            m["workloads"].append("wavenet_half.serve_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import registry\n"
            "c = registry.cell('wavenet_half.serve_small')\n"
            "assert c['traffic']['clients'] == 132 and len(c['config']['model']['dilations']) == 20\n"
            "assert [m['name'] for m in c['per_layer']][-1] == 'clips_done.serve'\n"
            "assert registry.reader('clips_done.serve')({'stats': {'latency': [1, 2]}}) == 2.0\n"
            "print('found')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "found"
