"""Seed plumbing on ``torch.Generator`` (counterpart of
:mod:`music_tpu.core.prng`).

Every stochastic call of the port takes an explicit generator.
:class:`KeySeq` hands out a deterministic sequence of them from one seed,
as the JAX package's ``KeySeq`` splits one PRNG key.  The numbers differ
from JAX's: parity tests carry weights across instead of reproducing an
initialization.

On a mesh, each ``data`` rank draws its own numbers (JAX folds the rank's
``axis_index("data")`` into the key): :func:`fold_in` derives a rank's seed
from the trainer's next seed and the rank's data index, so the ranks along
``model`` and ``seq`` that share a data index draw the same numbers, and
data index 0 draws what one device draws.
"""

from __future__ import annotations

import torch

_SEED_BOUND = 2**63 - 1


def fold_in(seed: int, index: int) -> int:
    """The seed of data index ``index`` from the stream's ``seed``:
    ``seed`` itself for index 0, else the ``index``-th draw of a generator
    seeded with it."""
    if index == 0:
        return int(seed)
    g = torch.Generator().manual_seed(int(seed))
    return int(torch.randint(0, _SEED_BOUND, (int(index),), generator=g)[-1])


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

    def next(self, device: torch.device | str | None = None, index: int = 0) -> torch.Generator:
        """The next generator, on ``device`` (default the CPU): a draw on a
        CUDA device needs a generator of that device.  ``index``: the data
        index of a mesh rank, folded into the seed (:func:`fold_in`)."""
        seed = fold_in(self.next_seed(), index)
        if device is None or torch.device(device).type == "cpu":
            return torch.Generator().manual_seed(seed)
        return torch.Generator(device=device).manual_seed(seed)

    def take(self, n: int) -> list[torch.Generator]:
        return [next(self) for _ in range(n)]
