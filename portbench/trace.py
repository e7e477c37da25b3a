"""What a run leaves for the per-layer metrics: every window frame's record,
and the profiler's raw records of the traced frames.

The profiler's raw records are read as they are (``kineto_results``);
building its event tree takes tens of seconds at these sizes. The harness
wraps each traced frame, synchronised, in a ``portbench_frame`` span, so a
frame's device work lies inside its span on the trace's clock.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

FRAME_SPAN = "portbench_frame"


@dataclass
class Trace:
    """The traced frames: ``frames`` (session, index, start ns, end ns) in
    order; ``device`` (name, start ns, duration ns) of every kernel, copy
    and fill; ``spans`` (name, start ns, duration ns) of every host-side
    record_function span; ``ops`` the same of every host operator."""

    frames: list = field(default_factory=list)
    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    ops: list = field(default_factory=list)

    @property
    def window_ns(self) -> int:
        return self.frames[-1][3] - self.frames[0][2] if self.frames else 0

    def busy_intervals(self) -> list:
        """The union of the device records' intervals inside the traced
        frames, as sorted (start, end) ns."""
        if not self.frames:
            return []
        lo, hi = self.frames[0][2], self.frames[-1][3]
        iv = sorted((max(s, lo), min(s + d, hi)) for _, s, d in self.device if s + d > lo and s < hi)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy_intervals())

    def in_frame(self, records: list, frame: tuple) -> list:
        """The records that start inside ``frame``'s span."""
        _, _, lo, hi = frame
        return [r for r in records if lo <= r[1] < hi]


def read_profile(prof) -> Trace:
    """A ``Trace`` from a stopped ``torch.profiler.profile``'s raw records."""
    from torch.autograd import DeviceType

    tr = Trace()
    frames = []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                tr.device.append(rec)
        elif e.is_user_annotation():
            if e.name().startswith(FRAME_SPAN + ":"):
                s, i = (int(x) for x in e.name().split(":")[1:3])
                frames.append((s, i, e.start_ns(), e.start_ns() + e.duration_ns()))
            else:
                tr.spans.append(rec)
        else:
            tr.ops.append(rec)
    tr.frames = sorted(frames, key=lambda f: f[2])
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device summed by what the host was doing at each gap's middle (the
    innermost span and operator covering it), each [name, seconds]."""
    by_op: dict = {}
    for name, _, d in tr.device:
        by_op[name] = by_op.get(name, 0.0) + d / 1e9
    busy = tr.busy_intervals()
    gaps = []
    if tr.frames:
        edges = [tr.frames[0][2]] + [x for iv in busy for x in iv] + [tr.frames[-1][3]]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]

    def innermost(records, starts, t):
        # the latest-starting record that covers t: nested records end
        # inside the ones around them
        for k in range(bisect.bisect_right(starts, t) - 1, max(-1, bisect.bisect_right(starts, t) - 5001), -1):
            name, s, d = records[k]
            if t < s + d:
                return name
        return "none"

    spans = sorted(tr.spans, key=lambda r: r[1])
    ops = sorted(tr.ops, key=lambda r: r[1])
    span_starts, op_starts = [r[1] for r in spans], [r[1] for r in ops]
    by_host: dict = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (s + e) // 2
        key = f"{innermost(spans, span_starts, mid)} / {innermost(ops, op_starts, mid)}"
        by_host[key] = by_host.get(key, 0.0) + (e - s) / 1e9
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    top_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in top_ops], "idle_gaps": [[k, v] for k, v in top_gaps]}


@dataclass
class Records:
    """What the per-layer readers read: ``frames``, one dict a window frame
    (``s`` session, ``i`` index in it, ``ms`` host clock from the call to
    the synchronised return, ``path`` and ``kf`` as the tracker reports
    them, ``pose`` whether a pose came back, ``stage_ms`` the keyframe
    epoch's and loop closer's stage ms it paid, ``prof`` whether it was
    traced); ``trace``, the traced frames' ``Trace`` (None untraced);
    ``settings``, the configuration's; and ``levels(s, i)``, the pyramid
    levels the extractor ran its kernels on in that frame (those with a
    keypoint budget), worked out again from its image."""

    frames: list
    trace: Trace | None
    settings: dict
    levels: object = None

    def traced(self, path: str = "fused") -> list:
        """The traced frames whose path is ``path``, as ``Trace.frames``
        entries."""
        if self.trace is None:
            return []
        want = {(f["s"], f["i"]) for f in self.frames if f["prof"] and f["path"] == path}
        return [fr for fr in self.trace.frames if (fr[0], fr[1]) in want]

    def before_mapping(self, frame: tuple) -> tuple:
        """``frame``'s span cut where its keyframe epoch or loop closing
        begins (its first ``kf_*`` or ``lc_*`` span): the step's part. The
        step reads its result back before the keyframe decision, so its
        device work ends before the epoch's begins."""
        s, i, lo, hi = frame
        starts = [t for name, t, _ in self.trace.in_frame(self.trace.spans, frame) if name.startswith(("kf_", "lc_"))]
        return s, i, lo, min(starts, default=hi)
