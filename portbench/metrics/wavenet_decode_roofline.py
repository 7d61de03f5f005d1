"""The WaveNet decode kernel's share of its roofline: the least time its
launches in the window could take (operations over the peak of the
served dtype, or bytes over the HBM rate, whichever is larger) over its
device time."""

from portbench import counts
from portbench.metrics._shares import decode_seconds


def read(ctx):
    dec = decode_seconds(ctx)
    launch = ctx.get("counts", {}).get("decode_launch")
    if dec is None or launch is None:
        return None
    least, _ = counts.min_seconds(launch["flops"], launch["bytes"], ctx["traffic"]["dtype"])
    return 100.0 * ctx["stats"]["calls"] * least / dec
