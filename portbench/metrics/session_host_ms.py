"""Host milliseconds a serving call spends in the session's own work while
nothing of the call is queued on the card: the host self time of the
program's ``session.pack`` (the rows' tails stacked and copied to the card)
and ``session.tails`` (the per-stream loop that keeps each tail) spans."""

from portbench.metrics._program import per


def read(ctx):
    return per(ctx, ["session.pack", "session.tails"], "self_ms", "calls")
