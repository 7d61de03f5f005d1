"""Plain WaveNet autoencoder (Engel et al. 2017, "Neural Audio Synthesis
of Musical Notes with WaveNet Autoencoders", the reference project's
``wavenet_autoencoder/model_params.json``): a temporal encoder pooled to
bottleneck frames and a WaveNet decoder conditioned on them, in plain
PyTorch.  Imports nothing of the program.

Encoder, per block: relu, dilated causal conv, relu, 1x1 conv, residual
add; a 1x1 bottleneck; mean pooling over ``pool`` steps (the tail that
fills no frame dropped).  Decoder, per block: dilated causal conv plus
the frame's projection ``cond_fg``, the gate ``tanh(second half) *
sigmoid(first half)``, 1x1 dense with a residual add, 1x1 skip; then
relu, ``conn1``, the frame's ``cond_post``, relu, ``conn2``.

Which frame conditions a position: the reference project's ratio rule,
position ``p`` of an output ``n`` long takes frame ``floor(p * F / n)``.
"""

from __future__ import annotations

import torch

from portbench.reference.common import (
    causal_conv, embed, matmul_precision, nll, receptive_field, weights_in,
)


def param_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    fw, L, Q = m["filter_width"], len(m["dilations"]), m["quantization_channel"]
    eCr, eCd = m["en_residual_channel"], m["en_dilation_channel"]
    Cr, Cd, Cs = m["de_residual_channel"], m["de_dilation_channel"], m["de_skip_channel"]
    W = m["en_bottleneck_width"]
    return {"en_causal": (fw, Q, eCr), "en_dil": (L, fw, eCr, eCd), "en_dense": (L, eCd, eCr),
            "bottleneck": (eCr, W), "de_causal": (fw, Q, Cr), "fg": (L, fw, Cr, 2 * Cd),
            "cond_fg": (L, W, 2 * Cd), "dense": (L, Cd, Cr), "skip": (L, Cd, Cs),
            "conn1": (Cs, Cs), "cond_post": (W, Cs), "conn2": (Cs, Q)}


def fan_in(m: dict) -> dict[str, int]:
    fw, Q, W = m["filter_width"], m["quantization_channel"], m["en_bottleneck_width"]
    return {"en_causal": Q * fw, "en_dil": m["en_residual_channel"] * fw,
            "en_dense": m["en_dilation_channel"], "bottleneck": m["en_residual_channel"],
            "de_causal": Q * fw, "fg": m["de_residual_channel"] * fw, "cond_fg": W,
            "dense": m["de_dilation_channel"], "skip": m["de_dilation_channel"],
            "conn1": m["de_skip_channel"], "cond_post": W, "conn2": m["de_skip_channel"]}


def encode(params: dict, tokens: torch.Tensor, m: dict, prec: str = "f32") -> torch.Tensor:
    """Bottleneck frames ``[B, (T - 1 - sum(d)) // pool, W]`` of codes
    ``tokens [B, T]``."""
    w = weights_in(params, prec)
    with matmul_precision(prec):
        x = embed(tokens, w["en_causal"])
        for i, d in enumerate(m["dilations"]):
            h = causal_conv(torch.relu(x), w["en_dil"][i], d)
            x = x[:, -h.shape[1]:] + torch.relu(h) @ w["en_dense"][i]
        x = x @ w["bottleneck"]
    k = m["en_pool_kernel_size"]
    n = x.shape[1] // k
    return x[:, : n * k].reshape(x.shape[0], n, k, x.shape[2]).mean(dim=2)


def _frames(n: int, F: int, device) -> torch.Tensor:
    """The frame of each of ``n`` consecutive outputs."""
    return (torch.arange(n, device=device) * F) // n


def logits(params: dict, tokens: torch.Tensor, frames: torch.Tensor, m: dict,
           prec: str = "f32") -> torch.Tensor:
    """Decoder logits ``[B, T - RF + 1, Q]`` over codes ``tokens [B, T]``
    conditioned on ``frames [B, F, W]``."""
    w = weights_in(params, prec)
    Cd, F = m["de_dilation_channel"], frames.shape[1]
    T = tokens.shape[1]
    out_w = T - receptive_field(m) + 1
    with matmul_precision(prec):
        x = embed(tokens, w["de_causal"])
        skip = None
        for i, d in enumerate(m["dilations"]):
            fg = causal_conv(x, w["fg"][i], d)
            n = fg.shape[1]
            proj = frames @ w["cond_fg"][i]  # [B, F, 2Cd]: one projection a frame
            fg = fg + proj[:, _frames(n, F, tokens.device)]
            z = torch.tanh(fg[..., Cd:]) * torch.sigmoid(fg[..., :Cd])
            x = x[:, -n:] + z @ w["dense"][i]
            s = z[:, -out_w:] @ w["skip"][i]
            skip = s if skip is None else skip + s
        post = (frames @ w["cond_post"])[:, _frames(out_w, F, tokens.device)]
        h = torch.relu(torch.relu(skip) @ w["conn1"] + post)
        return h @ w["conn2"]


def loss(params: dict, tokens: torch.Tensor, m: dict, prec: str = "f32") -> torch.Tensor:
    """Reconstruction cross entropy of windows ``tokens [B, RF + WL]``: the
    encoder and decoder read ``[:, :-1]``, the targets are ``[:, RF:]``."""
    inputs = tokens[:, :-1]
    frames = encode(params, inputs, m, prec)
    return nll(logits(params, inputs, frames, m, prec), tokens[:, receptive_field(m):])
