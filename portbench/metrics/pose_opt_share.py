"""step layer: the share of a traced fused frame's span, up to its keyframe
epoch if it has one, that the step's ``pose_opt_motion`` and
``pose_opt_local`` spans take, in percent (host time under the profiler:
the step does not synchronise, so its enqueue time is what bounds a
launch-bound step; the profiler slows every span alike, so the share, not
its milliseconds, carries over to the untraced ``fused_frame_ms``)."""

SPANS = ("pose_opt_motion", "pose_opt_local")


def read(rec):
    inside = total = 0
    for fr in rec.traced("fused"):
        step = rec.before_mapping(fr)
        inside += sum(d for name, _, d in rec.trace.in_frame(rec.trace.spans, step) if name in SPANS)
        total += step[3] - step[2]
    return 100.0 * inside / total if total > 0 else None
