"""What every run shares: its output directory, the card's identity, the
steps' profiles and the last JSON line."""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import torch

from music_tpu_torch.utils.profiling import device_busy_share

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


def phase_timer(device: torch.device, phases: tuple[str, ...]):
    """``(seconds, timed)``: ``timed(phase, fn, *args, **kwargs)`` calls
    ``fn`` with the device synchronised before and after and adds its
    seconds to ``seconds[phase]``."""
    seconds = dict.fromkeys(phases, 0.0)

    def timed(phase, fn, *args, **kwargs):
        sync(device)
        t1 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(device)
        seconds[phase] += time.perf_counter() - t1
        return out

    return seconds, timed


def step_profiles(device: torch.device, steps: dict) -> dict:
    """For each named call of ``steps``: its milliseconds (device
    synchronised) and, on the card, the device's busy milliseconds and
    share over a second call (:func:`device_busy_share`; ``None`` off the
    card).  The calls go on training the model, so a run profiles them
    after its results are taken."""
    out = {}
    for name, fn in steps.items():
        wall, busy, share = device_busy_share(device, fn)
        out[name] = {"ms": round(wall * 1e3, 2),
                     "busy_ms": round(busy * 1e3, 2) if share is not None else None,
                     "busy_share": round(share, 4) if share is not None else None}
    return out


def finish(out: dict, device: torch.device, t0: float, passed: bool) -> int:
    """Print ``out`` with the device, the card and the wall seconds as the
    last line; the exit code: 0 when ``passed``."""
    out.update(device=str(device), card=card_identity(device),
               wall_s=round(time.perf_counter() - t0, 1))
    print(json.dumps(out), flush=True)
    return 0 if passed else 1
