"""Shared runtime core: checkpoint I/O and params files."""
