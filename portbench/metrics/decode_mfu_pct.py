"""The whole serving step's share of the card's peak in the served dtype:
the model's operations for every sample delivered in the window over the
window's wall time."""

from portbench.metrics._shares import peak_pct


def read(ctx):
    st = ctx["stats"]
    return peak_pct(st["samples"] * ctx["counts"]["per_sample"], st["window_s"],
                    ctx["traffic"]["dtype"])
