"""Causal / dilated convolution primitives as shifted matmuls.

Counterpart of :mod:`music_tpu.ops.conv`, same layout: activations are
``[batch, time, channels]`` and weights ``[fw, in_ch, out_ch]``.  A valid
causal dilated conv is ``y[t] = sum_k x[t + k*d] @ w[k]`` over the input
window; ``w[-1]`` multiplies the newest step.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Run float32 matmuls and cuDNN convolutions in full float32.

    On a CUDA card cuDNN defaults to TF32 (about three decimal digits);
    the plain references the kernels are held against must not, so both
    switches are set off here and restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def dilated_causal_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    dilation: int = 1,
    *,
    fuse_taps: bool = False,
) -> torch.Tensor:
    """Valid (no-padding) causal dilated conv: ``[B, T, Cin] -> [B, T - (fw-1)*d, Cout]``.

    ``fuse_taps`` contracts the ``fw`` taps side by side with the reshaped
    ``[fw*Cin, Cout]`` weight in one matmul (same math, reassociated adds).
    """
    fw = w.shape[0]
    out_t = x.shape[1] - (fw - 1) * dilation
    if out_t <= 0:
        raise ValueError(f"sequence length {x.shape[1]} too short for fw={fw}, d={dilation}")
    taps = [x[:, k * dilation : k * dilation + out_t] for k in range(fw)]
    if fuse_taps:
        y = torch.cat(taps, dim=-1) @ w.reshape(fw * w.shape[1], w.shape[2])
    else:
        y = taps[0] @ w[0]
        for k in range(1, fw):
            y = y + taps[k] @ w[k]
    return y if b is None else y + b


def causal_conv(x, w, b=None):
    """Width-``fw`` causal conv with dilation 1 (the causal layer)."""
    return dilated_causal_conv(x, w, b, dilation=1)


def conv1x1(x, w, b=None):
    """Pointwise (1x1) conv: a matmul over the channel axis."""
    y = x @ w
    return y if b is None else y + b


def token_causal_conv(
    tokens: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    dilation: int = 1,
) -> torch.Tensor:
    """Causal dilated conv over the one-hot of integer tokens, computed as
    embedding gathers (``onehot(tok) @ w[k] == w[k][tok]``).

    ``tokens``: ``[B, T]`` int codes; ``w``: ``[fw, Q, Cout]``.
    Returns ``[B, T - (fw-1)*d, Cout]``.
    """
    fw = w.shape[0]
    out_t = tokens.shape[1] - (fw - 1) * dilation
    tokens = tokens.long()
    y = w[0][tokens[:, :out_t]]
    for k in range(1, fw):
        y = y + w[k][tokens[:, k * dilation : k * dilation + out_t]]
    return y if b is None else y + b
