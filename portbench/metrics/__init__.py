"""Per-layer metrics, one reader a file: ``<metric name>.py`` defines
``read(rec: portbench.trace.Records) -> float | None``. A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

import importlib.util
from pathlib import Path

DIR = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name.replace('.', '_')}", DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
