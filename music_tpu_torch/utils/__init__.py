"""Utilities: parity checks, loss plots, profiling."""
