"""Device milliseconds a training step spends in the gradients
(``tree_grads``, autograd's backward): the program's ``step.backward`` span
in ``core/optim.grad_update``, from its entry event to its exit event on
the stream."""

from portbench.metrics._program import per


def read(ctx):
    return per(ctx, ["step.backward"], "device_ms", "steps")
