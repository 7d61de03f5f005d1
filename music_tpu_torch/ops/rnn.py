"""Recurrent cells as plain functions on dicts of tensors (counterpart of
:mod:`music_tpu.ops.rnn`).

A fused-gate LSTM cell: ``gates = x @ wi + h @ wh + bi + bh`` with the
gates in torch's (i, f, g, o) order, under the JAX package's keys
(``wi [In, 4H]``, ``wh [H, 4H]``, ``bi``, ``bh``), so checkpoints cross
packages unchanged.  ``torch.nn.LSTM`` and cuDNN are not used: their
weights are ``[4H, In]`` with another bias handling, and the JAX function
is this plain GEMM cell.  :func:`lstm_scan` is a Python loop over time.

Also here: the pytree helpers the GAN families share
(:func:`tree_from_numpy`, :func:`tree_to_numpy`) and the host check of
token ids (:func:`check_token_ids`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _uniform(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (2.0 * torch.rand(shape, generator=generator) - 1.0) * bound


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int,
              init: str = "torch", device: torch.device | str = "cpu") -> dict:
    """``init="torch"``: U(-1/sqrt(H), 1/sqrt(H)) for all weights and
    biases (the ``nn.LSTMCell`` default); ``init="normal"``: N(0, 1)
    everywhere (the target-LSTM oracle's init)."""
    shapes = {"wi": (in_dim, 4 * hidden), "wh": (hidden, 4 * hidden),
              "bi": (4 * hidden,), "bh": (4 * hidden,)}
    if init == "normal":
        draw = lambda shape: torch.randn(shape, generator=generator)
    elif init == "torch":
        draw = lambda shape: _uniform(generator, shape, 1.0 / np.sqrt(hidden))
    else:
        raise ValueError(f"unknown init {init!r}")
    return {k: draw(shape).to(device) for k, shape in shapes.items()}


def lstm_cell(params: dict, x: torch.Tensor, state: tuple[torch.Tensor, torch.Tensor]):
    """One LSTM step.  x: [B, In]; state: (h, c) each [B, H] -> (h', c')."""
    h, c = state
    gates = x @ params["wi"] + h @ params["wh"] + params["bi"] + params["bh"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_zero_state(batch: int, hidden: int, device: torch.device | str = "cpu",
                    dtype: torch.dtype = torch.float32):
    zeros = torch.zeros((batch, hidden), device=device, dtype=dtype)
    return zeros, zeros.clone()


def lstm_scan(params: dict, xs: torch.Tensor, state=None):
    """Teacher-forced LSTM over a sequence.  xs: [B, T, In].

    Returns (hs [B, T, H], (h_T, c_T))."""
    if state is None:
        state = lstm_zero_state(xs.shape[0], params["wh"].shape[0], xs.device, xs.dtype)
    hs = []
    for t in range(xs.shape[1]):
        state = lstm_cell(params, xs[:, t], state)
        hs.append(state[0])
    return torch.stack(hs, dim=1), state


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                init: str = "torch", device: torch.device | str = "cpu") -> dict:
    """``init="torch"``: the ``nn.Linear`` default U(±1/sqrt(in));
    ``init="normal"``: N(0, 1) everywhere."""
    if init == "normal":
        w = torch.randn((in_dim, out_dim), generator=generator)
        b = torch.randn((out_dim,), generator=generator)
    elif init == "torch":
        bound = 1.0 / np.sqrt(in_dim)
        w = _uniform(generator, (in_dim, out_dim), bound)
        b = _uniform(generator, (out_dim,), bound)
    else:
        raise ValueError(f"unknown init {init!r}")
    return {"w": w.to(device), "b": b.to(device)}


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; one ``addmm`` for a 2-D ``x``."""
    if x.dim() == 2:
        return torch.addmm(params["b"], x, params["w"])
    return x @ params["w"] + params["b"]


def embedding_init(generator: torch.Generator, vocab: int, dim: int, std: float = 1.0,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The ``nn.Embedding`` default: N(0, 1), scaled by ``std``."""
    return (std * torch.randn((vocab, dim), generator=generator)).to(device)


def tree_from_numpy(tree: Any, device: torch.device | str = "cpu") -> Any:
    """A JAX parameter tree as numpy arrays (nested dicts, and lists such as
    a discriminator's ``convs``) as float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`tree_from_numpy`: numpy arrays in JAX's
    structure (``convs`` a list, in order)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def check_token_ids(tokens, vocab_size: int, what: str = "token ids") -> None:
    """Raise ``ValueError`` unless every id lies in ``[0, vocab_size)``.

    ``jnp.take`` clamps an id out of range silently; torch indexing raises,
    and on a CUDA device as a device-side assert that ends the process.
    So the host checks ids (numpy arrays) before they reach the card."""
    arr = np.asarray(tokens)
    if arr.size == 0:
        return
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or hi >= vocab_size:
        raise ValueError(f"{what} must lie in [0, {vocab_size}); found ids in [{lo}, {hi}]")
