"""Mean wall time of a session call in the window: the joins of the clips
requested since the last call and its ``step``."""


def read(ctx):
    calls = ctx.get("stats", {}).get("call_s")
    return 1000.0 * sum(calls) / len(calls) if calls else None
