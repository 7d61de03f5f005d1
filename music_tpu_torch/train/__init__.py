"""Trainers (single device)."""
