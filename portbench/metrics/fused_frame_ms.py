"""system layer (``SlamSystem``, ``Tracking``): the mean host ms of the
window's untraced frames that took the fused step alone and made no
keyframe."""


def read(rec):
    ms = [f["ms"] for f in rec.frames if f["path"] == "fused" and not f["kf"] and not f["prof"]]
    return sum(ms) / len(ms) if ms else None
