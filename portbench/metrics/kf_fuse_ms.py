"""keyframe epoch: the mean host ms of an untraced window epoch's
``kf_fuse`` stage (landmark fusion with the neighbours, and its host merge
loop)."""


def read(rec):
    ep = [f["stage_ms"].get("kf_fuse", 0.0) for f in rec.frames if f["kf"] and not f["prof"]]
    return sum(ep) / len(ep) if ep else None
