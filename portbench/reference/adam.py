"""Plain Adam (Kingma and Ba 2015, as optax applies it): bias-corrected
moments, ``p -= lr * m_hat / (sqrt(v_hat) + eps)``, each step on the
gradient of a plain loss by autograd."""

from __future__ import annotations

from typing import Callable

import torch

from portbench.reference.common import matmul_precision


def train(params: dict, batches: list[torch.Tensor], loss_fn: Callable, lr: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, prec: str = "f32"):
    """``len(batches)`` Adam steps from ``params`` (not changed), forward
    and backward in ``prec`` (``loss_fn(params, batch, prec)``): returns
    ``(losses, first_grads, params_after)``, the loss of every step, the
    first step's gradient of every leaf and the parameters after the last
    step."""
    with matmul_precision(prec):
        return _train(params, batches, loss_fn, lr, b1, b2, eps, prec)


def _train(params, batches, loss_fn, lr, b1, b2, eps, prec):
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, batch in enumerate(batches, 1):
        live = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(live, batch, prec)
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in p:
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v2[k] / (1 - b2 ** t)
                p[k] = p[k].detach() - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return losses, first, p
