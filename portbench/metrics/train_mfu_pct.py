"""The training step's share of the card's peak in the trained dtype: the
model's operations (forward and backward, 3 x the forward) of every step
in the window over its wall time."""

from portbench.metrics._shares import peak_pct


def read(ctx):
    st = ctx["stats"]
    return peak_pct(st["steps"] * ctx["counts"]["step_flops"], st["window_s"],
                    ctx["traffic"]["dtype"])
