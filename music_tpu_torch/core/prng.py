"""Seed plumbing on ``torch.Generator`` (counterpart of
:mod:`music_tpu.core.prng`).

Every stochastic call of the port takes an explicit generator.
:class:`KeySeq` hands out a deterministic sequence of them from one seed,
as the JAX package's ``KeySeq`` splits one PRNG key.  The numbers differ
from JAX's: parity tests carry weights across instead of reproducing an
initialization.
"""

from __future__ import annotations

import torch

_SEED_BOUND = 2**63 - 1


class KeySeq:
    """A reproducible stream of ``torch.Generator``s (or their seeds) from
    one seed: the same seed gives the same sequence in every process."""

    def __init__(self, seed: int):
        self._parent = torch.Generator().manual_seed(int(seed))

    def next_seed(self) -> int:
        """The next child seed, an int in ``[0, 2**63 - 1)``."""
        return int(torch.randint(0, _SEED_BOUND, (1,), generator=self._parent))

    def __next__(self) -> torch.Generator:
        return torch.Generator().manual_seed(self.next_seed())

    def next(self, device: torch.device | str | None = None) -> torch.Generator:
        """The next generator, on ``device`` (default the CPU): a draw on a
        CUDA device needs a generator of that device."""
        if device is None or torch.device(device).type == "cpu":
            return next(self)
        return torch.Generator(device=device).manual_seed(self.next_seed())

    def take(self, n: int) -> list[torch.Generator]:
        return [next(self) for _ in range(n)]
