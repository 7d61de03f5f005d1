"""Tensor primitives shared across model families (plain PyTorch)."""
