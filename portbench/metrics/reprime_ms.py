"""Device milliseconds a serving call spends in the session's re-prime
(the program's ``decode.prepare`` span: the rows' pad, the f32 conv that
rebuilds the decode kernel's ring state, the kernel's weights), from its
entry event to its exit event on the stream."""

from portbench.metrics._program import per


def read(ctx):
    return per(ctx, ["decode.prepare"], "device_ms", "calls")
