"""Utilities: map checkpoints."""
