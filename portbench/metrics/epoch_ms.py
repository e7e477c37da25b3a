"""keyframe epoch (``LocalMapper``): the mean host ms of an untraced
window epoch, the sum of its ``kf_*`` stages (``LocalMapper.stage_s``)."""


def read(rec):
    ep = [sum(v for k, v in f["stage_ms"].items() if k.startswith("kf_")) for f in rec.frames
          if f["kf"] and not f["prof"]]
    return sum(ep) / len(ep) if ep else None
