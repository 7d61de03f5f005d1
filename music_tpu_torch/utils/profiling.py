"""Profiling and timing on ``torch.profiler`` (counterpart of
:mod:`music_tpu.utils.profiling`).

- :func:`trace`: a context manager around ``torch.profiler.profile`` (the
  CPU, and CUDA when a card is present) that writes a Chrome trace;
  :data:`annotate` names a span in it.
- :func:`phase_fractions`: the forward / backward / optimizer wall-clock
  shares of a training step (the reference's ``wavenet/test.py:44-69``
  breakdown), the device synchronised between phases.
- :func:`time_fn`: the median wall-clock of a call, synchronised.
- :func:`device_busy_share`: a call's wall seconds and the seconds the
  card was busy during it.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from music_tpu_torch.core import optim

annotate = torch.profiler.record_function


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path = "trace"):
    """Profile the block; on exit write ``log_dir/trace.json`` (Chrome
    trace format).  Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def phase_fractions(
    loss_fn: Callable,
    params,
    batch,
    tx: optim.GradientTransformation,
    opt_state,
    n_iters: int = 10,
) -> dict[str, float]:
    """Forward / backward / optimizer wall-clock fractions of
    ``loss_fn(params, batch)`` trained by ``tx``: the forward without
    autograd, the backward as the JAX version's ``jax.grad`` (forward and
    backward), the optimizer's update and ``apply_updates``; each phase
    ends with the device synchronised.  Params and state are not changed."""
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


def time_fn(fn: Callable, make_args: Callable[[int], tuple], n: int = 3) -> float:
    """Median wall-clock seconds of ``fn(*make_args(i))`` for ``i`` in
    ``1..n``, after one warm-up call, each ending with the device
    synchronised."""
    fn(*make_args(0))
    times = []
    for i in range(1, n + 1):
        args = make_args(i)
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def device_busy_share(dev: torch.device, fn: Callable) -> tuple[float, float, float | None]:
    """``fn()``'s wall seconds (host clock, device synchronised), its device
    busy seconds (the CUDA activities ``torch.profiler`` records over a
    second call) and their ratio; ``(wall, 0.0, None)`` off the card, and a
    ratio of ``None`` when the profiler saw no device time."""
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
    # the raw device events: summed in milliseconds, where building
    # prof.events() takes seconds for a step of ~30k launches
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) * 1e-9
    return wall, busy, (busy / wall if busy > 0 else None)
