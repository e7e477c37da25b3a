"""Utilities: map checkpoints, logging, the viewer, profiling."""
