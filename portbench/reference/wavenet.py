"""Plain WaveNet (van den Oord et al. 2016, the reference project's
``wavenet_params.json``): its parameter shapes, teacher-forced logits and
training loss, in plain PyTorch.  Imports nothing of the program.

Parameters, keyed as the reference project's pytree: ``causal [fw, Q,
Cr]``, ``fg [L, fw, Cr, 2Cd]`` (filter first half, gate second), ``dense
[L, Cd, Cr]``, ``skip [L, Cd, Cs]``, ``post1 [Cs, Cs]``, ``post2 [Cs, Q]``;
no biases.
"""

from __future__ import annotations

import torch

from portbench.reference.common import (
    causal_conv, embed, matmul_precision, nll, receptive_field, rounder, weights_in,
)


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    fw, L, Q = m["filter_width"], len(m["dilations"]), m["quantization_channels"]
    Cr, Cd, Cs = m["residual_channels"], m["dilation_channels"], m["skip_channels"]
    return {"causal": (fw, Q, Cr), "fg": (L, fw, Cr, 2 * Cd), "dense": (L, Cd, Cr),
            "skip": (L, Cd, Cs), "post1": (Cs, Cs), "post2": (Cs, Q)}


def fan_in(m: dict) -> dict[str, int]:
    """Inputs per output of each weight (the init's bound is its root's
    inverse)."""
    fw = m["filter_width"]
    return {"causal": m["quantization_channels"] * fw, "fg": m["residual_channels"] * fw,
            "dense": m["dilation_channels"], "skip": m["dilation_channels"],
            "post1": m["skip_channels"], "post2": m["skip_channels"]}


def logits(params: dict, tokens: torch.Tensor, m: dict, prec: str = "f32") -> torch.Tensor:
    """Logits ``[B, T - RF + 1, Q]`` over codes ``tokens [B, T]``: output
    ``i`` predicts the code after ``tokens[:, i + RF - 1]``.  ``prec``: see
    :mod:`portbench.reference.common`; with ``"fp8"`` the activations are
    rounded where the decode kernel rounds its bfloat16 ones."""
    rnd = rounder(prec)
    w = weights_in(params, prec)
    Cd = m["dilation_channels"]
    out_w = tokens.shape[1] - receptive_field(m) + 1
    with matmul_precision(prec):
        x = rnd(embed(tokens, w["causal"]))
        skip = None
        for i, d in enumerate(m["dilations"]):
            fg = causal_conv(x, w["fg"][i], d)
            z = rnd(torch.tanh(fg[..., :Cd]) * torch.sigmoid(fg[..., Cd:]))
            x = rnd(x[:, -fg.shape[1]:] + z @ w["dense"][i])
            s = z[:, -out_w:] @ w["skip"][i]
            skip = s if skip is None else skip + s
        h = rnd(torch.relu(skip))
        h = rnd(torch.relu(h @ w["post1"]))
        return h @ w["post2"]


def loss(params: dict, tokens: torch.Tensor, m: dict, prec: str = "f32") -> torch.Tensor:
    """Next-code cross entropy of windows ``tokens [B, RF + WL]``: the
    inputs are ``[:, :-1]``, the targets ``[:, RF:]``."""
    return nll(logits(params, tokens[:, :-1], m, prec), tokens[:, receptive_field(m):])
