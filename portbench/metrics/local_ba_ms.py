"""BA (``optim/ba.py``): the mean host ms of an untraced window epoch's
``kf_local_ba`` stage."""


def read(rec):
    ep = [f["stage_ms"].get("kf_local_ba", 0.0) for f in rec.frames if f["kf"] and not f["prof"]]
    return sum(ep) / len(ep) if ep else None
