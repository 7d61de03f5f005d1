"""Spans of the benchmark's own calls, and the reduction of a profiler
trace of the measured window to the numbers the per-layer metrics read.

:class:`Spans` records the benchmark's calls into the program on the host
clock the profiler stamps device events with (``time.time_ns``), only
while the window is traced.  With tracing on, :class:`Window` runs
``torch.profiler`` over the window with the device's activity alone (no
record of every host operation, which would double a training step's
time), keeps the trace in memory, and reduces it to:

- ``busy_s``: the union of the device's intervals (kernels, copies, sets)
  inside the window, so that overlapping operations count once;
- ``kernel_s``: device seconds by operation name;
- ``idle_gaps``: the longest stretches of the window with nothing on the
  device, each named by the innermost span the host was in at its middle
  (``outside_spans`` when none).
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch


class Spans:
    """``with spans("step"): ...`` records ``(start_ns, end_ns, name)``
    while :attr:`on`."""

    def __init__(self):
        self.on = False
        self.items: list[tuple[int, int, str]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.items.append((a, time.time_ns(), name))


def union_seconds(intervals: list[tuple[int, int]], lo: int, hi: int) -> float:
    """Seconds of ``[lo, hi)`` (ns) covered by the union of ``intervals``."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total * 1e-9


def idle_gaps(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of ``[lo, hi)`` that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return gaps


def _innermost(spans: list[tuple[int, int, str]], starts: list[int], t: int) -> str:
    """The name of the shortest span that holds time ``t``."""
    best = None
    for a, b, name in spans[: bisect.bisect_right(starts, t)]:
        if a <= t < b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "outside_spans"


class Window:
    """The measured window, with ``traced`` the profiler around it and the
    spans on.  After the ``with`` block, :attr:`summary` holds the
    reduction (``None`` untraced)."""

    def __init__(self, traced: bool, device: torch.device, spans: Spans):
        self.traced, self.device, self.spans = traced, device, spans
        self.summary = None
        self._prof = None

    def __enter__(self):
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" else [
                ProfilerActivity.CPU]
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self.spans.on = True
        self.open_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.close_ns = time.time_ns()
        self.spans.on = False
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = self._reduce()
        return False

    def _reduce(self) -> dict:
        from torch.autograd import DeviceType

        lo, hi = self.open_ns, self.close_ns
        device = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = e.start_ns()
            b = a + e.duration_ns()
            if b > lo and a < hi:
                device.append((max(a, lo), min(b, hi), e.name()))
        intervals = [(a, b) for a, b, _ in device]
        kernel_s: dict[str, float] = {}
        for a, b, n in device:
            kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) * 1e-9
        host = sorted(x for x in self.spans.items if x[1] > lo and x[0] < hi)
        starts = [a for a, _, _ in host]
        gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:10]
        return {
            "window_s": (hi - lo) * 1e-9,
            "busy_s": union_seconds(intervals, lo, hi),
            "kernel_s": kernel_s,
            "idle_gaps": [[_innermost(host, starts, (a + b) // 2), (b - a) * 1e-9]
                          for a, b in gaps],
        }
