"""Hidden-split (tensor-parallel) LSTM over the mesh's ``model`` axis
(counterpart of :mod:`music_tpu.parallel.rnn_tp`).

Rank ``s`` of ``m`` owns hidden units ``[s*H/m, (s+1)*H/m)``: their four
gate columns, their slice of the cell state ``c`` and their slice of ``h``.
The gates are packed (i, f, g, o)-major in the weights' ``4H`` columns, so
a contiguous split of that axis would scatter a unit's gates over ranks;
:func:`repack_lstm_params` permutes the columns gate-major within each
rank's block, and a contiguous split by :func:`lstm_specs` then gives each
rank ``[In, 4H/m]`` columns holding all four gates of its own units.

A step computes this rank's gates from its columns and the whole ``h``,
updates its ``c`` and ``h`` slices, and gathers the whole ``h`` back (one
``[B, H]`` gather a step, :func:`~music_tpu_torch.parallel.collectives.gather_from`);
``c`` never leaves its rank.  The replicated inputs enter the rank's
columns through ``copy_to``, so their gradients sum over ``model``.

JAX's ``lstm_zero_state_tp`` has no counterpart: its zero-valued jitter
gives the carries the varying-axis types ``shard_map`` checks, machinery of
JAX's type system like ``parallel/vma.py`` (ROADMAP.md, "Do not port");
plain zeros are the same numbers.

Used by the C-RNN-GAN discriminator's bi-LSTM stack
(:func:`music_tpu_torch.parallel.gan_tp.crnngan_forward_tp`).
"""

from __future__ import annotations

import numpy as np
import torch

from music_tpu_torch.ops.rnn import lstm_update
from music_tpu_torch.parallel.collectives import copy_to, gather_from
from music_tpu_torch.parallel.mesh import P


def lstm_specs() -> dict:
    """Partition specs of a repacked LSTM parameter dict."""
    return {"wi": P(None, "model"), "wh": P(None, "model"), "bi": P("model"),
            "bh": P("model")}


def _gate_perm(H: int, m: int) -> np.ndarray:
    """Column permutation of the ``4H`` axis: rank-major, then gate-major,
    then unit."""
    Hl = H // m
    idx = []
    for s in range(m):
        for gate in range(4):
            start = gate * H + s * Hl
            idx.extend(range(start, start + Hl))
    return np.asarray(idx)


def check_hidden(H: int, m: int) -> None:
    if H % m:
        raise ValueError(f"hidden {H} not divisible by model axis {m}")


def _permute(params: dict, perm: np.ndarray) -> dict:
    idx = torch.as_tensor(perm, device=params["wh"].device)
    return {"wi": params["wi"][:, idx], "wh": params["wh"][:, idx],
            "bi": params["bi"][idx], "bh": params["bh"][idx]}


def repack_lstm_params(params: dict, m: int) -> dict:
    """The ``4H`` gate columns permuted so that a split by :func:`lstm_specs`
    gives each rank all four gates of its own hidden units."""
    H = params["wh"].shape[0]
    check_hidden(H, m)
    return _permute(params, _gate_perm(H, m))


def unpack_lstm_params(params: dict, m: int) -> dict:
    """The inverse of :func:`repack_lstm_params` (torch's gate order)."""
    H = params["wh"].shape[0]
    check_hidden(H, m)
    return _permute(params, np.argsort(_gate_perm(H, m)))


def lstm_cell_tp(params_local: dict, x: torch.Tensor,
                 state: tuple[torch.Tensor, torch.Tensor], group):
    """One hidden-split LSTM step.  ``x [B, In]`` replicated; ``state``:
    (``h [B, H]`` whole on every rank, ``c [B, H/m]`` this rank's slice).
    Returns the same structure."""
    h_full, c_local = state
    gates = (copy_to(x, group) @ params_local["wi"] + copy_to(h_full, group) @ params_local["wh"]
             + params_local["bi"] + params_local["bh"])
    h_local, c_local = lstm_update(gates, c_local)
    return gather_from(h_local, group, -1), c_local


def lstm_stack_tp(layers: list[dict], xs: torch.Tensor, group) -> torch.Tensor:
    """Independent hidden-split LSTMs side by side over inputs known up
    front (the split form of the C-RNN-GAN discriminator's ``_lstm_stack``):
    ``xs [L, T, B, In]`` replicated, one slab for each of the ``L`` layers'
    local parameters -> ``[L, T, B, H]`` whole on every rank.  The input
    products of all steps are one batched GEMM; a step is one batched GEMM
    of the recurrent products on this rank's columns, one gate update and
    one gather of ``h`` for all ``L``."""
    L, T, B, _ = xs.shape
    xs = copy_to(xs, group)
    wi = torch.stack([p["wi"] for p in layers])
    wh = torch.stack([p["wh"] for p in layers])
    bias = torch.stack([p["bi"] + p["bh"] for p in layers])[:, None]
    H, Hl = wh.shape[1], wh.shape[2] // 4
    xw = torch.baddbmm(bias, xs.reshape(L, T * B, -1), wi).reshape(L, T, B, 4 * Hl)
    h = torch.zeros((L, B, H), device=xs.device, dtype=xs.dtype)
    c = torch.zeros((L, B, Hl), device=xs.device, dtype=xs.dtype)
    hs = []
    for t in range(T):
        h_local, c = lstm_update(torch.baddbmm(xw[:, t], copy_to(h, group), wh), c)
        h = gather_from(h_local, group, -1)
        hs.append(h)
    return torch.stack(hs, dim=1)
