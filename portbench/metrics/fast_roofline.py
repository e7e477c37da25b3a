"""kernel A (``csrc/fast_score_nms.cu``): the least time of its work
(``portbench/roofline.py``, from the pyramid each launch saw) over its
device time, summed over the traced fused frames, in percent."""

from portbench.roofline import bound_s, fast_work

KERNEL = "fast_score_nms_kernel"


def read(rec):
    least = took = 0.0
    for fr in rec.traced("fused"):
        launches = [d for name, _, d in rec.trace.in_frame(rec.trace.device, fr) if KERNEL in name]
        if len(launches) != 1:
            continue
        least += bound_s(*fast_work(rec.levels(fr[0], fr[1])))
        took += launches[0] / 1e9
    return 100.0 * least / took if took > 0 else None
