"""Model families (PyTorch)."""
