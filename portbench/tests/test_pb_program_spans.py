"""The readers of the program's spans: their numbers per call or step of a
traced window, and nothing from a program that has no recorder, no spans
or an untraced window."""

from __future__ import annotations

import pytest

from portbench import registry
from portbench.tests import tiny

SERVE = {"reprime_ms.serve": ["decode.prepare"],
         "session_host_ms.serve": ["session.pack", "session.tails"]}
TRAIN = {"train_forward_ms.train": ["step.forward"],
         "train_backward_ms.train": ["step.backward"],
         "train_update_ms.train": ["step.update"]}


def _recorded(names_per_unit: list[str], units: int) -> dict:
    from music_tpu_torch.utils import profiling

    with profiling.recording():
        for _ in range(units):
            for name in names_per_unit:
                with profiling.span(name):
                    pass
    return profiling.summary()


@pytest.mark.parametrize("metrics,unit", [(SERVE, "calls"), (TRAIN, "steps")])
def test_readers_give_span_ms_per_unit(metrics, unit):
    names = sorted({n for ns in metrics.values() for n in ns})
    spans = _recorded(names, 3)
    ctx = {"trace": {"busy_s": 1.0}, "stats": {unit: 3}}
    for metric, read_names in metrics.items():
        field = "self_ms" if metric.startswith("session_host") else "device_ms"
        want = sum(spans[n][field] for n in read_names) / 3
        assert registry.reader(metric)(ctx) == pytest.approx(want)
        assert registry.reader(metric)({"trace": None, "stats": {unit: 3}}) is None


def test_readers_give_nothing_without_the_recorder_or_its_spans(monkeypatch):
    from music_tpu_torch.utils import profiling

    ctx = {"trace": {"busy_s": 1.0}, "stats": {"calls": 2, "steps": 2}}
    _recorded(["unrelated"], 1)
    assert all(registry.reader(m)(ctx) is None for m in {**SERVE, **TRAIN})
    monkeypatch.delattr(profiling, "summary")
    assert all(registry.reader(m)(ctx) is None for m in {**SERVE, **TRAIN})


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_tiny_traced_run_reports_the_span_metrics(cell):
    from portbench import harness

    spec = tiny.cell(cell)
    r = harness.run_cell(spec, 2**31 + 3, 0.5, True, "cpu")
    want = {m["name"] for m in spec["per_layer"] if m["source"] == "program_span"
            and m["name"] != "session_call_ms.serve"}
    assert want and want <= set(r["metrics"]), r["metrics"]
