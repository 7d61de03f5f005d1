"""µ-law companding codec.

Counterpart of :mod:`music_tpu.ops.mulaw`: encode in float32 with the same
op order and a final truncation toward zero; decode through the Q=256
table committed beside this module (a copy of the JAX package's, bit-exact
against the reference's torch arithmetic), with the analytic float32
formula for other Q.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch


@functools.cache
def _decode_table_q256() -> np.ndarray:
    """The committed bit-exact Q=256 decode table."""
    return np.load(Path(__file__).with_name("_mulaw_decode_q256.npy"))


def mu_law_encode(audio: torch.Tensor, quantization_channels: int = 256) -> torch.Tensor:
    """Encode float audio in [-1, 1] to int32 µ-law codes in [0, Q-1]."""
    audio = audio.to(torch.float32)
    mu = torch.tensor(quantization_channels - 1, dtype=torch.float32, device=audio.device)
    safe_abs = torch.abs(torch.clamp(audio, -1.0, 1.0))
    magnitude = torch.log1p(mu * safe_abs) / torch.log1p(mu)
    signal = torch.sign(audio) * magnitude
    encoded = (signal + 1.0) / 2.0 * mu + 0.5
    # encoded >= 0, so truncation toward zero is the floor
    return encoded.to(torch.int32)


def mu_law_decode(codes: torch.Tensor, quantization_channels: int = 256) -> torch.Tensor:
    """Decode int µ-law codes back to float32 audio in [-1, 1]."""
    if quantization_channels == 256:
        table = torch.from_numpy(_decode_table_q256()).to(codes.device)
        return table[codes.long()]
    mu = torch.tensor(quantization_channels - 1, dtype=torch.float32, device=codes.device)
    signal = 2.0 * (codes.to(torch.float32) / mu) - 1.0
    magnitude = (1.0 / mu) * ((1.0 + mu) ** torch.abs(signal) - 1.0)
    return torch.sign(signal) * magnitude
