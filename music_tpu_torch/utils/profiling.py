"""Profiling and timing on ``torch.profiler`` (counterpart of
:mod:`music_tpu.utils.profiling`).

- :func:`span`: names a stretch of the program's work.  Spans are kept in
  memory while :func:`recording` runs or a ``torch.profiler`` session is
  active, and cost two attribute tests otherwise; :func:`summary` reads
  them.  The program opens them at its layer boundaries: ``session.pack``,
  ``session.fetch`` and ``session.tails`` in
  ``generate/serving.DecodeSession.step``, ``decode.prepare`` and
  ``decode.launch`` in ``kernels/wavenet_decode.generate_tokens_fused``,
  ``step.forward``, ``step.backward`` and ``step.update`` in
  ``core/optim.grad_update``.
- :func:`trace`: a context manager around ``torch.profiler.profile`` (the
  CPU, and CUDA when a card is present) that writes a Chrome trace holding
  the program's spans.
- :func:`phase_fractions`: the forward / backward / optimizer wall-clock
  shares of a training step (the reference's ``wavenet/test.py:44-69``
  breakdown), the device synchronised between phases.
- :func:`device_busy_share`: a call's wall seconds and the seconds the
  card was busy during it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Callable

import torch
import torch.autograd.profiler as _torch_profiler
from torch.profiler import ProfilerActivity, profile


class _Recorder:
    """``on`` while :func:`recording` runs; the spans closed since it last
    started; each thread's stack of open spans."""

    def __init__(self):
        self.on = False
        self.spans: list[_Span] = []
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class _Span:
    """One recorded span: its name, the span that opened it, its host start
    and end (``time.time_ns``, the clock ``torch.profiler`` stamps device
    events with), the host time its children cover and, on a card, a CUDA
    event on the current stream at entry and at exit."""

    __slots__ = ("name", "parent", "t0", "t1", "child_ns", "ev0", "ev1")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0
        self.ev0 = self.ev1 = None

    def __enter__(self):
        st = _REC.stack()
        self.parent = st[-1] if st else None
        st.append(self)
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        _REC.stack().pop()
        if self.parent is not None:
            self.parent.child_ns += self.t1 - self.t0
        _REC.spans.append(self)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("decode.prepare"): ...`` records the block as a span
    while :func:`recording` runs or a ``torch.profiler`` session is active
    (so a profiled run of the program carries its spans; they are kept
    until the next :func:`recording` starts); else it records nothing."""
    if not (_REC.on or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Record spans in the block; the spans of earlier recordings are
    dropped on entry.  No device synchronisation happens inside."""
    was = _REC.on
    _REC.spans = []
    _REC.on = True
    try:
        yield
    finally:
        _REC.on = was


def summary() -> dict[str, dict]:
    """The recorded spans by name: ``count``; ``host_ms`` (host clock);
    ``self_ms`` (host ms less what the span's children cover); ``device_ms``
    (from the entry event to the exit event, in the stream's order; host ms
    off the card); ``parents`` (the names of the spans that opened it,
    ``None`` at the top); ``intervals`` (host ``(start_ns, end_ns)``).
    Waits for the device to reach each span's exit event: call it after
    recording stops."""
    out: dict[str, dict] = {}
    for s in list(_REC.spans):
        e = out.setdefault(s.name, {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                                    "device_ms": 0.0, "parents": [], "intervals": []})
        host = (s.t1 - s.t0) * 1e-6
        if s.ev0 is not None:
            s.ev1.synchronize()
            device = s.ev0.elapsed_time(s.ev1)
        else:
            device = host
        e["count"] += 1
        e["host_ms"] += host
        e["self_ms"] += host - s.child_ns * 1e-6
        e["device_ms"] += device
        e["intervals"].append((s.t0, s.t1))
        parent = s.parent.name if s.parent is not None else None
        if parent not in e["parents"]:
            e["parents"].append(parent)
    return out


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path = "trace"):
    """Profile the block with the program's spans recorded; on exit write
    ``log_dir/trace.json`` (Chrome trace format), the spans among its
    events (category ``program_span``).  Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / "trace.json"
    with recording(), profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    doc["traceEvents"] += [
        {"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": "program spans",
         "ts": (a - base) / 1e3, "dur": (b - a) / 1e3}
        for name, e in summary().items() for a, b in e["intervals"]]
    path.write_text(json.dumps(doc))


def phase_fractions(
    loss_fn: Callable,
    params,
    batch,
    tx,
    opt_state,
    n_iters: int = 10,
) -> dict[str, float]:
    """Forward / backward / optimizer wall-clock fractions of
    ``loss_fn(params, batch)`` trained by ``tx`` (an
    ``optim.GradientTransformation``): the forward without autograd, the
    backward as the JAX version's ``jax.grad`` (forward and backward), the
    optimizer's update and ``apply_updates``; each phase ends with the
    device synchronised.  Params and state are not changed."""
    from music_tpu_torch.core import optim

    def forward():
        with torch.no_grad():
            return loss_fn(params, batch)

    def backward():
        variables = optim.live(params)
        return optim.tree_grads(loss_fn(variables, batch), variables)

    def update(grads):
        with torch.no_grad():
            updates, _ = tx.update(grads, opt_state, params)
            return optim.apply_updates(params, updates)

    forward()
    update(backward())  # warm-up
    _sync()
    t_fwd = t_bwd = t_opt = 0.0
    for _ in range(n_iters):
        t0 = time.perf_counter()
        forward()
        _sync()
        t1 = time.perf_counter()
        grads = backward()
        _sync()
        t2 = time.perf_counter()
        update(grads)
        _sync()
        t3 = time.perf_counter()
        t_fwd += t1 - t0
        t_bwd += t2 - t1
        t_opt += t3 - t2
    total = t_fwd + t_bwd + t_opt
    return {
        "forward_frac": t_fwd / total,
        "backward_frac": t_bwd / total,
        "optimizer_frac": t_opt / total,
        "total_seconds": total / n_iters,
    }


def union_ns(intervals) -> int:
    """Nanoseconds covered by the union of ``(start_ns, end_ns)`` intervals,
    overlaps counted once."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_busy_share(dev: torch.device, fn: Callable) -> tuple[float, float, float | None]:
    """``fn()``'s wall seconds (host clock, device synchronised), its device
    busy seconds (the union of the CUDA activities ``torch.profiler``
    records over a second call, overlaps counted once) and their ratio;
    ``(wall, 0.0, None)`` off the card, and a ratio of ``None`` when the
    profiler saw no device time."""
    from torch.autograd import DeviceType

    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    wall = time.perf_counter() - t0
    if dev.type != "cuda":
        return wall, 0.0, None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    # the raw device events, where building prof.events() takes seconds
    # for a step of ~30k launches
    busy = union_ns((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA) * 1e-9
    return wall, busy, (busy / wall if busy > 0 else None)
