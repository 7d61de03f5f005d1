"""Audio file I/O."""
