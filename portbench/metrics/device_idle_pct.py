"""Share of the window in which no operation ran on the device (the union
of the device's intervals, not a sum of durations)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
