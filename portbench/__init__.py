"""The benchmark of the PyTorch and CUDA port, ``music_tpu_torch``: ``python -m portbench.run``."""
