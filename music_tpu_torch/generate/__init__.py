"""Generation entry points."""
