"""Device milliseconds a training step spends in the loss's forward
(``loss_fn``): the program's ``step.forward`` span in
``core/optim.grad_update``, from its entry event to its exit event on the
stream."""

from portbench.metrics._program import per


def read(ctx):
    return per(ctx, ["step.forward"], "device_ms", "steps")
