"""Run a function on N ranks of one host (a small ``torchrun``).

:func:`run` spawns ``world_size`` processes, joins them in one process
group through a TCP store on a free localhost port
(:func:`~music_tpu_torch.parallel.multihost.initialize`), calls
``fn(*args)`` on each and returns the ranks' results in rank order.  The
CPU tests run their meshes through it with gloo; ``chip_smoke.py`` runs two
gloo ranks on one card with it.  On the CPU each rank runs one intra-op
thread, as ``torchrun`` sets its workers: N ranks of the host's thread
count each would oversubscribe its cores many times over.

``fn`` must be importable by name (a module-level function), and its
arguments and result picklable; both travel
as plain pickle bytes through queues, tensors by value (the queue's own
pickler would hand the parent a shared-memory handle of a process that
exits).  Arguments sent with the process object instead would start the
ranks one after another: the parent's write of a process object larger
than a pipe's buffer waits until that child has imported the main module.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import socket
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from music_tpu_torch.parallel import multihost


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(payload, rank, world_size, port, backend, device, results):
    try:
        fn, args = pickle.loads(payload.get())
        if device == "cpu" and world_size > 1:
            torch.set_num_threads(1)  # as torchrun: the ranks share the host's cores
        multihost.initialize(f"127.0.0.1:{port}", world_size, rank, backend=backend,
                             device=device)
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn: Callable, world_size: int, args: Sequence[Any] = (), *, backend: str = "gloo",
        device: str = "cpu", timeout_s: float = 300.0) -> list:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each rank a
    spawned process of a ``backend`` process group on ``device``.  Raises
    with the failing ranks' tracebacks if any rank raises or the run
    outlasts ``timeout_s``; no process outlives the call."""
    ctx = mp.get_context("spawn")
    results, payload = ctx.Queue(), ctx.Queue()
    data = pickle.dumps((fn, tuple(args)))
    for _ in range(world_size):
        payload.put(data)
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(payload, r, world_size, port, backend, device, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        for _ in range(world_size):
            rank, ok, value = results.get(timeout=timeout_s)
            if ok:
                got[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    except queue.Empty:
        errors.append(f"no result within {timeout_s} s from ranks "
                      f"{sorted(set(range(world_size)) - set(got))}")
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world_size)]
