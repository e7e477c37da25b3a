"""Per-frame structured logging and per-stage wall-clock timing.

Port of ``orbslam_in_practice_tpu/utils/logging.py`` (host only).
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager


class StageTimer:
    """Accumulates host wall-clock seconds and call counts per named stage."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }


class FrameLog:
    """Per-frame records, kept in memory and appended as JSON lines to
    ``path`` when given."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records = []

    def log(self, **kv):
        kv.setdefault("t", time.time())
        self.records.append(kv)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(kv) + "\n")
