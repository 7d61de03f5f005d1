"""The one generator of every traffic mix: it reads a mix's parameters
(``traffic/<name>.json``) and the run's seed, and makes the inputs.

Every seed gets the same sizes in another order: a deck of clip lengths
at fixed quantiles of the mix's law, dealt in an order drawn from the
seed.  The audio (sine mixtures) and the weights differ from seed to seed;
the work does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seeds(seed: int, n: int = 8) -> list[int]:
    """``n`` independent sub-seeds of a run's ``--seed`` (any whole number)."""
    return [int(s) for s in np.random.default_rng(int(seed)).integers(0, 2**62, size=n)]


def quantiles(lo: float, hi: float, n: int, law: str) -> np.ndarray:
    """``n`` values at the mid-quantiles ``(k + 0.5) / n`` of ``law`` on
    ``[lo, hi]``: ``uniform`` or ``log_uniform``."""
    u = (np.arange(n) + 0.5) / n
    if law == "uniform":
        return lo + (hi - lo) * u
    if law == "log_uniform":
        return lo * (hi / lo) ** u
    raise ValueError(f"unknown law {law!r}")


class Deck:
    """Deals the values of a fixed deck, reshuffled from ``rng`` at every
    pass."""

    def __init__(self, values: np.ndarray, rng: np.random.Generator):
        self.values, self.rng = values, rng
        self._order, self._i = rng.permutation(len(values)), 0

    def deal(self):
        if self._i == len(self._order):
            self._order, self._i = self.rng.permutation(len(self.values)), 0
        k = int(self._order[self._i])
        self._i += 1
        return self.values[k]


def clip_lengths(t: dict) -> np.ndarray:
    """The deck of clip lengths in samples."""
    lo, hi = t["clip_seconds"]
    secs = quantiles(lo, hi, t["deck"], t["clip_law"])
    return np.round(secs * t["sample_rate"]).astype(np.int64)


def mu_law(audio: torch.Tensor, q: int) -> torch.Tensor:
    """µ-law codes ``[0, q)`` of audio in [-1, 1] (float32, truncated)."""
    mu = float(q - 1)
    x = audio.clamp(-1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(mu)
    return ((y + 1.0) / 2.0 * mu + 0.5).to(torch.int32)


def sine_codes(t: dict, lengths: np.ndarray, seed: int, q: int, device) -> list[np.ndarray]:
    """One µ-law clip of each length: a sum of ``tones`` sines with random
    frequencies (log-uniform over ``tone_hz``), amplitudes and phases, plus
    ``noise``, scaled to a peak of 0.8.  Made on ``device`` in a few large
    calls; returned as host int32 arrays."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, total = len(lengths), int(np.sum(lengths))
    k = t["tones"][1]
    lo, hi = t["tone_hz"]
    params = torch.rand((n, k, 4), generator=gen, device=device)
    hz = lo * (hi / lo) ** params[..., 0]
    amp = params[..., 1] * (torch.arange(k, device=device) < torch.randint(
        t["tones"][0], k + 1, (n, 1), generator=gen, device=device)).float()
    phase = 2 * math.pi * params[..., 2]
    clip = torch.repeat_interleave(torch.arange(n, device=device),
                                   torch.as_tensor(lengths, device=device))
    starts = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)[:-1]]), device=device)
    time = (torch.arange(total, device=device) - starts[clip]).float() / t["sample_rate"]
    wave = torch.zeros(total, device=device)
    for j in range(k):
        wave += amp[clip, j] * torch.sin(2 * math.pi * hz[clip, j] * time + phase[clip, j])
    wave += t["noise"] * torch.randn(total, generator=gen, device=device)
    peak = torch.zeros(n, device=device).scatter_reduce(0, clip, wave.abs(), "amax")
    codes = mu_law(0.8 * wave / peak[clip].clamp_min(1e-6), q).cpu().numpy()
    return np.split(codes, np.cumsum(lengths)[:-1])
