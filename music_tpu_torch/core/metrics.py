"""Metrics logging (counterpart of :mod:`music_tpu.core.metrics`).

- ``MetricsLogger``: structured JSONL metrics plus the text log
  ``loss_log.log``, whose line ``Trained over <N> pieces,Average loss is
  <loss>`` is byte-compatible with the JAX package's (its resume parser
  and loss plot read tokens by position), and a ``store_log.log`` event
  channel.
- ``Meter``: streaming mean over a reporting window (``print_every``).
- ``Throughput``: wall-clock items per second.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class Meter:
    """Streaming average over a reporting window."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.total += float(value) * n
        self.count += n

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0


class Throughput:
    """Wall-clock items/sec meter (blocks on device work via the caller)."""

    def __init__(self):
        self.items = 0
        self._t0 = time.perf_counter()

    def update(self, n: int):
        self.items += n

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self.items / dt if dt > 0 else 0.0

    def reset(self):
        self.items = 0
        self._t0 = time.perf_counter()


class MetricsLogger:
    """Dual-format metrics sink.

    ``log_loss(epoch, step, loss)`` appends
    - a JSONL record to ``metrics.jsonl`` (structured, greppable), and
    - a text line ``'Trained over <N> pieces,Average loss is <loss>'`` to
      ``loss_log.log``, whose token positions are load-bearing: the step
      is ``split(' ')[2]`` and the loss follows the last space.
    """

    def __init__(self, log_dir: str | Path, echo: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = self.log_dir / "metrics.jsonl"
        self._loss_log = self.log_dir / "loss_log.log"
        self._store_log = self.log_dir / "store_log.log"
        self.echo = echo

    def log(self, record: dict[str, Any]):
        record = dict(record, time=time.time())
        with self._jsonl.open("a") as f:
            f.write(json.dumps(record) + "\n")
        if self.echo:
            print(" ".join(f"{k}={v}" for k, v in record.items() if k != "time"))

    def log_loss(self, epoch: int, step: int, loss: float, **extra: Any):
        self.log({"kind": "loss", "epoch": epoch, "step": step, "loss": float(loss), **extra})
        with self._loss_log.open("a") as f:
            f.write(f"Trained over {step} pieces,Average loss is {float(loss)}\n")

    def log_event(self, message: str, **extra: Any):
        self.log({"kind": "event", "message": message, **extra})
        with self._store_log.open("a") as f:
            f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {message}\n")

    def last_step(self) -> int:
        """The step of the last ``loss_log.log`` line (0 without one)."""
        if not self._loss_log.exists():
            return 0
        lines = self._loss_log.read_text().strip().splitlines()
        if not lines:
            return 0
        return int(lines[-1].split(" ")[2])
