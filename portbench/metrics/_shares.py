"""Arithmetic the per-layer readers share: a decode kernel's device
seconds in the traced window, and a share of the card's peak."""

from __future__ import annotations

from portbench import counts


def decode_seconds(ctx: dict) -> float | None:
    """Device seconds of the operations whose name holds the config's
    ``decode_kernel``; ``None`` when the trace has none."""
    tr = ctx.get("trace")
    if not tr:
        return None
    s = sum(v for k, v in tr["kernel_s"].items() if ctx["config"]["decode_kernel"] in k)
    return s or None


def peak_pct(flops: float, seconds: float, dtype: str) -> float | None:
    """``flops`` in ``seconds`` as a percentage of the peak of ``dtype``."""
    if flops <= 0 or seconds <= 0:
        return None
    return 100.0 * flops / seconds / counts.PEAKS["flops"][dtype]
