"""Device milliseconds a training step spends in the optimizer's update
and ``apply_updates``: the program's ``step.update`` span in
``core/optim.grad_update``, from its entry event to its exit event on the
stream."""

from portbench.metrics._program import per


def read(ctx):
    return per(ctx, ["step.update"], "device_ms", "steps")
