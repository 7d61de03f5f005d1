"""Precision and convolution helpers shared by the plain references.

``prec`` names the arithmetic a reference runs in:

- ``"f32"``: float32 with TF32 off for matmuls and cuDNN (the reference);
- ``"tf32"``: float32 with TF32 on (the control for a float32 program);
- ``"fp8"``: weights and activations rounded to float8 e4m3 with a scale
  per tensor, at the points where the bfloat16 decode kernel rounds (the
  control for a bfloat16 program).
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


@contextlib.contextmanager
def matmul_precision(prec: str):
    """TF32 on for ``"tf32"``, off otherwise; restored on exit."""
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec == "tf32"
    torch.backends.cudnn.allow_tf32 = prec == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, returned in float32."""
    amax = x.detach().abs().max().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def rounder(prec: str):
    """The rounding applied at the decode kernel's rounding points."""
    return fp8 if prec == "fp8" else (lambda v: v)


def weights_in(params: dict, prec: str) -> dict:
    """``params`` as float32, each rounded to float8 for ``"fp8"``."""
    rnd = rounder(prec)
    return {k: rnd(v.float()) for k, v in params.items()}


def causal_conv(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Valid causal conv of ``x [B, T, Cin]`` with taps ``w [fw, Cin,
    Cout]``: ``y[t] = sum_k x[t + k*d] @ w[k]``, ``T - (fw - 1) * d`` long."""
    fw = w.shape[0]
    out = x.shape[1] - (fw - 1) * dilation
    y = x[:, :out] @ w[0]
    for k in range(1, fw):
        y = y + x[:, k * dilation : k * dilation + out] @ w[k]
    return y


def embed(tokens: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The causal conv over one-hot codes ``tokens [B, T]`` with taps ``w
    [fw, Q, C]``, as row gathers: ``[B, T - fw + 1, C]``."""
    fw = w.shape[0]
    out = tokens.shape[1] - fw + 1
    tokens = tokens.long()
    y = w[0][tokens[:, :out]]
    for k in range(1, fw):
        y = y + w[k][tokens[:, k : k + out]]
    return y


def receptive_field(model: dict) -> int:
    return (model["filter_width"] - 1) * (sum(model["dilations"]) + 1) + 1


def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-code cross entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None]).mean()
