"""Utilities: parity checks."""
