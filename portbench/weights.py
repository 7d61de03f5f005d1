"""Weights from the seed, on the device, in one draw: every weight ``U(-1 /
sqrt(fan_in), 1 / sqrt(fan_in))`` (the reference project's init), float32,
the type both sessions and trainers take them in."""

from __future__ import annotations

import math

import torch


def make(shapes: dict[str, tuple[int, ...]], fan_in: dict[str, int], seed: int,
         device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(s) for s in shapes.values()]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(u, sizes)):
        bound = 1.0 / math.sqrt(fan_in[name])
        out[name] = ((2.0 * part - 1.0) * bound).reshape(shape)
    return out
