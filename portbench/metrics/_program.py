"""The program's own spans (``music_tpu_torch.utils.profiling``), which it
records while the traced window's profiler runs: their milliseconds per
call or step of the window.  A program without the recorder or without
the spans gives ``None``."""

from __future__ import annotations


def per(ctx: dict, names: list[str], field: str, unit: str) -> float | None:
    """The sum of ``field`` (``device_ms`` or ``self_ms``) over the spans
    ``names`` in the window, over the window's ``unit`` (``calls`` or
    ``steps``)."""
    n = ctx.get("stats", {}).get(unit)
    if not ctx.get("trace") or not n:
        return None
    try:
        from music_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    spans = summary() if summary is not None else {}
    if not all(name in spans for name in names):
        return None
    return sum(spans[name][field] for name in names) / n
