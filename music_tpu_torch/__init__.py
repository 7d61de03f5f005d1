"""music_tpu_torch — the PyTorch/CUDA port of :mod:`music_tpu`.

A second package beside the JAX one, with the same layout and names so a
reader can find each counterpart:

- ``music_tpu_torch.core``     — checkpoint I/O in the JAX package's format.
- ``music_tpu_torch.ops``      — µ-law codec, conv primitives, sampling, Philox.
- ``music_tpu_torch.models``   — WaveNet (forward, loss, plain step decoder).
- ``music_tpu_torch.kernels``  — hand-written CUDA kernels (sources under
  ``csrc/``) with their plain PyTorch versions.
- ``music_tpu_torch.generate`` — the generation entry points.

Parameters keep the JAX layout (channels-last activations, conv weights
``[fw, in, out]``, stacked ``[L, ...]`` block params), so weights move
between the two packages unchanged.  This package never imports ``jax``;
it reuses only the JAX package's jax-free modules (``core.config``,
``data.wavio``, the µ-law table and the params JSONs).
"""

__version__ = "0.1.0"
