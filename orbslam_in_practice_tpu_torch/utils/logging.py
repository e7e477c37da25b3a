"""The port's record of spans and counters, and per-frame JSON logs.

Port of ``orbslam_in_practice_tpu/utils/logging.py`` (host only).
``StageTimer`` is the one record every layer of the port writes to. A span
(``stage``) adds its host duration under its name and, while a profiler
records the thread, is also a ``record_function`` of the same name, so it
lies on the clock of the trace's device records. A counter (``count``)
adds an integer under a name. Totals run over the record's life and every
thread; a ``scope`` (a frame, a keyframe epoch) collects what its own
thread records inside it, and scopes nest: a span or a count adds to every
scope open on its thread. PERF.md lists the spans and counters and what
reads each.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager

from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

EPOCH_HISTORY = 256  # finished epoch records kept until taken


class Scope:
    """What one thread recorded inside a ``StageTimer.scope``: span name ->
    host ns, counter name -> sum."""

    __slots__ = ("spans_ns", "counts")

    def __init__(self):
        self.spans_ns: dict = {}
        self.counts: dict = {}

    def spans_ms(self) -> dict:
        return {k: v / 1e6 for k, v in self.spans_ns.items()}


class _Span:
    __slots__ = ("timer", "name", "t0", "rf")

    def __init__(self, timer, name: str):
        self.timer, self.name, self.rf = timer, name, None

    def __enter__(self):
        if _profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.timer._add(self.name, ns)
        return False


class StageTimer:
    """Spans and counters of one tracker (its mapper, loop closer, fused
    step and mapping worker write here too). ``totals`` span -> host
    seconds, ``calls`` span -> spans closed, ``counters`` counter -> sum,
    each over every thread; ``epochs`` the finished keyframe epochs'
    records, oldest first, until ``take_epochs``. Safe to use from several
    threads."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.calls = defaultdict(int)
        self.counters = defaultdict(int)
        self.epochs: deque = deque(maxlen=EPOCH_HISTORY)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _open(self) -> list:
        """The scopes open on this thread, innermost last."""
        try:
            return self._local.scopes
        except AttributeError:
            self._local.scopes = []
            return self._local.scopes

    def _add(self, name: str, ns: int):
        for sc in self._open():
            sc.spans_ns[name] = sc.spans_ns.get(name, 0) + ns
        with self._lock:
            self.totals[name] += ns * 1e-9
            self.calls[name] += 1

    def stage(self, name: str) -> _Span:
        """A span: ``with timer.stage(name): ...``."""
        return _Span(self, name)

    def count(self, name: str, n: int = 1):
        n = int(n)
        for sc in self._open():
            sc.counts[name] = sc.counts.get(name, 0) + n
        with self._lock:
            self.counters[name] += n

    @contextmanager
    def scope(self):
        """Collect this thread's spans and counts inside the block; yields
        the ``Scope``."""
        sc = Scope()
        scopes = self._open()
        scopes.append(sc)
        try:
            yield sc
        finally:
            scopes.remove(sc)

    @contextmanager
    def epoch(self, kf_seq: int, queued_ns: int | None = None):
        """A keyframe epoch's scope (its loop-closure attempt included); on
        exit its record joins ``epochs``: ``kf_seq``, ``spans_ms``,
        ``counts`` and, for an epoch queued at ``perf_counter_ns()``
        ``queued_ns``, ``queue_wait_ms`` from then to its start."""
        start = time.perf_counter_ns()
        with self.scope() as sc:
            yield sc
        rec = {"kf_seq": int(kf_seq), "spans_ms": sc.spans_ms(), "counts": dict(sc.counts)}
        if queued_ns is not None:
            rec["queue_wait_ms"] = (start - queued_ns) / 1e6
        self.epochs.append(rec)

    def take_epochs(self) -> list:
        """The finished epochs' records not taken yet, oldest first."""
        out = []
        while self.epochs:
            out.append(self.epochs.popleft())
        return out

    def snapshot(self) -> tuple:
        """(totals, calls, counters) as they are now, for ``seconds`` and
        ``counted``."""
        with self._lock:
            return dict(self.totals), dict(self.calls), dict(self.counters)

    def seconds(self, names, since: tuple) -> dict:
        """Host seconds of the spans ``names`` closed since the snapshot
        ``since``, for those that closed at least once."""
        totals, calls, _ = since
        with self._lock:
            return {n: self.totals[n] - totals.get(n, 0.0) for n in names
                    if self.calls.get(n, 0) > calls.get(n, 0)}

    def counted(self, name: str, since: tuple) -> int:
        """Counter ``name``'s sum since the snapshot ``since``."""
        with self._lock:
            return self.counters.get(name, 0) - since[2].get(name, 0)

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.calls[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.calls[name], 1),
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
