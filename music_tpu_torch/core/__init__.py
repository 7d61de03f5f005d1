"""Shared runtime core: checkpoint I/O."""
