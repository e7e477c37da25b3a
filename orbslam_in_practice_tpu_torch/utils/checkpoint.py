"""Map checkpoints: the slot tables as one compressed npz.

Port of ``orbslam_in_practice_tpu/utils/checkpoint.py`` with the same keys,
so a map saved by either package loads in the other. Loading builds a new
map with ``SlamMap.from_numpy``: free lists are the invalid slots below the
high-water marks, covisibility is rebuilt from the observations, and the
keyframes' global descriptors, which the file does not hold, are computed
again from their features.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.slam.map import SlamMap
from orbslam_in_practice_tpu_torch.slam.place_recognition import global_descriptor

ARRAY_FIELDS = (
    "kf_pose", "kf_valid", "kf_xy", "kf_octave", "kf_angle", "kf_feat_valid", "kf_desc_pm1", "kf_obs",
    "lm_pos", "lm_valid", "lm_desc_pm1", "lm_normal", "lm_min_dist", "lm_max_dist", "lm_octave",
)
HOST_FIELDS = ("kf_frame_id", "kf_seq", "lm_first_kf", "lm_uid", "lm_obs_count", "lm_found_count", "lm_visible_count")
SCALARS = ("n_kf", "n_lm", "next_kf_id", "_next_lm_uid")


def save_map(path: str, smap: SlamMap):
    data = {f: smap.hview(f) for f in ARRAY_FIELDS}
    data.update({f: getattr(smap, f) for f in HOST_FIELDS})
    data.update({f: np.asarray(getattr(smap, f)) for f in SCALARS})
    np.savez_compressed(path, **data)


def load_map(path: str, device: torch.device | str = "cuda") -> SlamMap:
    """The map saved at ``path``, its tables on ``device``."""
    with np.load(path) as data:
        tables = {f: data[f] for f in ARRAY_FIELDS + HOST_FIELDS}
        n_kf, n_lm = int(data["n_kf"]), int(data["n_lm"])
        tables.update(n_kf=n_kf, n_lm=n_lm, next_kf_id=int(data["next_kf_id"]), next_lm_uid=int(data["_next_lm_uid"]))
    kf_valid, lm_valid = tables["kf_valid"], tables["lm_valid"]
    tables["kf_free"] = np.nonzero(~kf_valid[:n_kf])[0]
    tables["lm_free"] = np.nonzero(~lm_valid[:n_lm])[0]
    tables["lm_free_pending"] = []
    gdesc = np.zeros((len(kf_valid), 256), np.float32)
    for k in np.nonzero(kf_valid)[0]:
        gdesc[k] = global_descriptor(
            torch.from_numpy(tables["kf_desc_pm1"][k]), torch.from_numpy(tables["kf_feat_valid"][k])
        ).numpy()
    tables["kf_gdesc"] = gdesc
    return SlamMap.from_numpy(tables, device)
