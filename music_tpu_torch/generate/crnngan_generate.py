"""C-RNN-GAN generation (counterpart of
:mod:`music_tpu.generate.crnngan_generate`): sample the generator,
denormalize, clamp to the physical ranges and write a MIDI file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from music_tpu_torch.data.midi import events_to_midi
from music_tpu_torch.generate.wavenet_generate import resolve_device
from music_tpu_torch.models import crnngan as cg


def generate(
    g_params: dict,
    cfg: cg.CRnnGanConfig,
    out_path: str | Path,
    *,
    scaler=None,
    length: int | None = None,
    seed: int = 0,
    ticks_per_quarter_note: int = 384,
    meta=None,
    noise: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Generate one song on ``device`` and write it as a MIDI file; returns
    the ``[T, 4]`` events written (delta_tick, length, freq, velocity): G's
    output after the optional ``scaler.inverse`` and the clamps.

    ``meta``: an optional ``[meta_dim]`` genre/composer one-hot row
    conditioning the generator (``cfg.meta_dim > 0``).  ``noise``: the
    ``[T, 1, noise_dim]`` uniforms, else drawn from a generator seeded with
    ``seed``."""
    device = resolve_device(device)
    params = {k: {n: torch.as_tensor(v).to(device, torch.float32) for n, v in layer.items()}
              for k, layer in g_params.items()}
    if meta is not None:
        meta = torch.as_tensor(np.asarray(meta, np.float32).reshape(1, -1)).to(device)
    generator = torch.Generator(device).manual_seed(seed) if noise is None else None
    with torch.no_grad():
        events = cg.generate(params, cfg, 1, length, meta, generator=generator,
                             noise=noise)[0].cpu().numpy()
    if scaler is not None:
        events = scaler.inverse(events)
    # clamp to physical ranges
    events[:, 0] = np.maximum(events[:, 0], 0.0)     # delta ticks
    events[:, 1] = np.maximum(events[:, 1], 1.0)     # length
    events[:, 2] = np.clip(events[:, 2], 8.18, 12543.85)  # MIDI 0..127 in Hz
    events[:, 3] = np.clip(events[:, 3], 1, 127)     # velocity
    events_to_midi(events, out_path, ticks_per_quarter_note)
    return events
