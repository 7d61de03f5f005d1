"""End-to-end runs of the port, each a module run as
``python -m music_tpu_torch.runs.<name>`` that prints one JSON line last
and exits non-zero when its pass flag is false:

- :mod:`~music_tpu_torch.runs.wavenet_poly_quality_run`: the 40-block
  WaveNet trained on an A-major chord and its decode's spectrum
  (``--config scaled``: the 4.4x-scaled width, every decoded token held
  tie-aware against the plain model);
- :mod:`~music_tpu_torch.runs.wavenet_ae_quality_run`: the full-size
  autoencoder trained on two tones, each reconstructed at its own pitch;
- :mod:`~music_tpu_torch.runs.cli_journey_run`: the user's CLI workflow,
  every hop a subprocess of ``python -m music_tpu_torch``.

They are the counterparts of the JAX package's ``benchmarks/`` scripts of
the same names, with the same protocols and pass criteria.  Each takes
``--device`` (default ``cuda``; without a card it fails unless ``--device
cpu`` is given) and shrinks to a tiny configuration for the CPU.
"""
