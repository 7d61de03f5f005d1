"""Loss-curve visualization.

Parity surface: wavenet/vis/visualize.py:7-24 — parse ``loss_log.log``
(format ``'Trained over <N> pieces,Average loss is <loss>'``) and save a
matplotlib curve as ``loss.png``.  Also reads the structured
``metrics.jsonl`` the framework writes alongside.
"""

from __future__ import annotations

import json
from pathlib import Path


def get_loss(log_path: str | Path) -> tuple[list[int], list[float]]:
    """Parse the reference-format text log (visualize.py:7-15)."""
    steps, losses = [], []
    for line in Path(log_path).read_text().splitlines():
        parts = line.split(" ")
        if len(parts) >= 7 and parts[0] == "Trained":
            steps.append(int(parts[2]))
            losses.append(float(parts[-1]))
    return steps, losses


def get_loss_jsonl(metrics_path: str | Path) -> tuple[list[int], list[float]]:
    steps, losses = [], []
    for line in Path(metrics_path).read_text().splitlines():
        rec = json.loads(line)
        if rec.get("kind") == "loss":
            steps.append(rec["step"])
            losses.append(rec["loss"])
    return steps, losses


def plot_loss(log_path: str | Path, out_path: str | Path = "loss.png"):
    """Render the loss curve (visualize.py:18-24)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    log_path = Path(log_path)
    if log_path.suffix == ".jsonl":
        steps, losses = get_loss_jsonl(log_path)
    else:
        steps, losses = get_loss(log_path)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.plot(steps, losses)
    ax.set_xlabel("trained pieces")
    ax.set_ylabel("average loss")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
