"""Mean host time a training step waited for its next batch from the
data path (``AudioWindows`` through ``PrefetchBatches``), on the host's
clock."""


def read(ctx):
    st = ctx["stats"]
    return 1000.0 * st["wait_s"] / st["steps"] if st.get("steps") else None
