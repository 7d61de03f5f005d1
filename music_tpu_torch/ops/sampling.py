"""Sampling primitives (counterpart of :mod:`music_tpu.ops.sampling`).

All take logits.  Random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch


def argmax_sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy: index of the max logit on the last axis, first index on ties
    (as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def categorical(
    generator: torch.Generator | None, logits: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """Sample from ``softmax(logits / temperature)``."""
    if temperature != 1.0:
        logits = logits / temperature
    probs = torch.softmax(logits.float(), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)


def gumbel_noise(generator: torch.Generator | None, shape, device=None) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform on ``device``
    (a CUDA device needs a CUDA generator)."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min(1e-20)
    return -torch.log(-torch.log(u))


def gumbel_argmax(generator: torch.Generator | None, logits: torch.Tensor) -> torch.Tensor:
    """Categorical sampling by Gumbel-max: one uniform draw and an argmax."""
    return torch.argmax(logits + gumbel_noise(generator, logits.shape, logits.device),
                        dim=-1).to(torch.int32)
