"""What every run shares: its output directory, the card's identity and
the last JSON line."""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import torch

RUNS_DIR = Path(__file__).resolve().parents[2] / "build" / "runs"
"""Default root of the runs' outputs: ``build/runs/<run>`` in the checkout."""


def card_identity(device: torch.device) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them; ``None``
    off the card."""
    if device.type != "cuda":
        return None
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def finish(out: dict, device: torch.device, t0: float, passed: bool) -> int:
    """Print ``out`` with the device, the card and the wall seconds as the
    last line; the exit code: 0 when ``passed``."""
    out.update(device=str(device), card=card_identity(device),
               wall_s=round(time.perf_counter() - t0, 1))
    print(json.dumps(out), flush=True)
    return 0 if passed else 1
