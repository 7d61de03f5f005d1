"""music_tpu_torch — the PyTorch/CUDA port of :mod:`music_tpu`.

A second package beside the JAX one, with the same layout and names so a
reader can find each counterpart:

- ``music_tpu_torch.core``     — checkpoint I/O in the JAX package's format,
  params JSON loading.
- ``music_tpu_torch.data``     — wav I/O and resampling.
- ``music_tpu_torch.ops``      — µ-law codec, conv primitives, sampling, Philox.
- ``music_tpu_torch.models``   — WaveNet and the WaveNet autoencoder (forward,
  loss, plain step decoders).
- ``music_tpu_torch.kernels``  — hand-written CUDA kernels (sources under
  ``csrc/``) with their plain PyTorch versions.
- ``music_tpu_torch.generate`` — the generation entry points.
- ``music_tpu_torch.parallel`` — the (data, seq, model) mesh over
  ``torch.distributed`` ranks, one process per device.
- ``music_tpu_torch.params``   — the shipped model configs (JSON).

Parameters keep the JAX layout (channels-last activations, conv weights
``[fw, in, out]``, stacked ``[L, ...]`` block params), so weights move
between the two packages unchanged.  This package imports neither ``jax``
nor anything of ``music_tpu``: what it needs of the JAX package's jax-free
modules (config loading, wav I/O, the µ-law table, the params JSONs) it
keeps as its own copies.  Its entry points run on a CUDA device unless
the caller asks for the CPU.
"""

__version__ = "0.1.0"
