"""Finds everything by name: a cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its check
(``limits/<cell>.json``), the family that drives it
(``systems/<family>.py``, named in the configuration) and the readers of
its per-layer metrics (``metrics/<metric>.py``, or for a quantity split by
the metric it moves, such as ``device_idle_pct.serve``, the reader of the
quantity, ``metrics/device_idle_pct.py``).  Adding any of them is adding
files and entries; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(path.read_text())


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.name}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def family(config: dict):
    """The module that drives a configuration's family on the program."""
    return importlib.import_module(f"portbench.systems.{config['family']}")


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``, else of the file named
    by the metric's name up to its first dot."""
    for stem in dict.fromkeys((metric, metric.split(".")[0])):
        path = HERE / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"portbench_metric_{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise KeyError(f"no reader for metric {metric!r}")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell, or those its
    ``workloads`` list."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict | None = None) -> dict:
    """Everything a run of cell ``name`` needs, loaded."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return {
        "name": name, "chips": entry["chips"],
        "config": config(entry["config"]), "traffic": traffic(entry["traffic"]),
        "limits": limits(name),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m, name)],
        "per_layer": [m for m in bench["per_layer"] if reports(m, name)],
    }
