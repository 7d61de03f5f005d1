"""Hand-written CUDA kernels (sources under ``music_tpu_torch/csrc/``), each
beside its plain PyTorch version.  A wrapper takes the plain version only
for tensors on the CPU; on a CUDA tensor it launches the kernel or raises."""
