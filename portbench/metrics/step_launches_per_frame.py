"""step layer (``FusedSteadyStep``): device records (kernels, copies and
fills) a traced fused frame, from the profiler's raw device records inside
the frame's span before its keyframe epoch, if it has one."""


def read(rec):
    frames = rec.traced("fused")
    if not frames:
        return None
    return sum(len(rec.trace.in_frame(rec.trace.device, rec.before_mapping(fr))) for fr in frames) / len(frames)
