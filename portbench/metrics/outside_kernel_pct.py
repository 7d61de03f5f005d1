"""Share of the serving window's wall time the decode kernel was not
running: the session's re-prime, copies, per-stream work and joins."""

from portbench.metrics._shares import decode_seconds


def read(ctx):
    dec = decode_seconds(ctx)
    if dec is None:
        return None
    return 100.0 * (1.0 - dec / ctx["trace"]["window_s"])
