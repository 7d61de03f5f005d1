"""Shared runtime core: checkpoint I/O, params files, optimizers, metrics
and seeds."""
