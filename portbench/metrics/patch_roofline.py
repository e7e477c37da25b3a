"""kernel B (``csrc/orb_patch.cu``): the least time of its work
(``portbench/roofline.py``: the extractor's keypoint budget over the
pyramid each launch saw) over its device time, summed over the traced fused
frames, in percent."""

from portbench.reference.extract import level_budgets
from portbench.roofline import bound_s, patch_work

KERNEL = "orb_patch_kernel"


def read(rec):
    n = sum(level_budgets(*(rec.settings[k] for k in ("n_features", "n_levels", "scale_factor"))))
    least = took = 0.0
    for fr in rec.traced("fused"):
        launches = [d for name, _, d in rec.trace.in_frame(rec.trace.device, fr) if KERNEL in name]
        if len(launches) != 1:
            continue
        least += bound_s(*patch_work(rec.levels(fr[0], fr[1]), n))
        took += launches[0] / 1e9
    return 100.0 * least / took if took > 0 else None
