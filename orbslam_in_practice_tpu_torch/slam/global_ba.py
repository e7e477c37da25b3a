"""Full-map (global) bundle adjustment.

Port of ``orbslam_in_practice_tpu/slam/global_ba.py``: every valid keyframe
and landmark in one ``bundle_adjustment`` (``optim/ba.py``), written back,
and observations with chi2 > 5.991 scrubbed. The loop closer runs it after
the essential-graph correction, with the loop candidate fixed. Above
``DENSE_ASSEMBLY_MAX_CAMS`` cameras the Schur system is assembled landmark
chunk by landmark chunk.

The reference pads the problem to bucketed shapes so that XLA compiles few
programs; PyTorch needs no fixed shapes, so the problem here has exactly the
map's cameras, landmarks and observations (padding cameras are fixed and
unobserved, so they change nothing but the system's size).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.optim.ba import (
    BAProblem,
    adaptive_o_max,
    build_point_obs,
    bundle_adjustment,
    count_obs_drops,
)

O_MAX = 16
O_CAP = 24  # cap of the per-landmark observation budget
ITERATIONS = 10  # LM iterations: the loop closer's (the reference's default, 15, has no caller here)
_LOG = logging.getLogger("orbslam_tpu_torch")


def global_bundle_adjustment(smap, K: torch.Tensor, inv_level_sigma2: np.ndarray, fixed_kfs):
    """Optimise all valid keyframes and landmarks; write back and scrub.

    K: (3, 3) on the map's device; inv_level_sigma2: (n_levels,) host array;
    fixed_kfs: keyframe slots held fixed (the gauge).

    Returns (n_cams, n_points, n_obs) optimised.
    """
    valid_kf = smap.kf_valid_host()[: smap.n_kf]
    cams = [int(k) for k in range(smap.n_kf) if valid_kf[k]]
    if len(cams) < 2:
        return 0, 0, 0
    lm_ids = np.nonzero(smap.lm_valid_host())[0]
    if len(lm_ids) == 0:
        return 0, 0, 0
    kf_idx, feat_idx, which = smap.observations_of(lm_ids)
    keep = np.isin(kf_idx, cams)
    kf_idx, feat_idx, which = kf_idx[keep], feat_idx[keep], which[keep]
    cam_slot = np.full(smap.k_max, -1, np.int64)
    cam_slot[cams] = np.arange(len(cams))
    obs_oct = smap.hview("kf_octave")[kf_idx, feat_idx]
    inv_s2 = inv_level_sigma2[np.clip(obs_oct, 0, len(inv_level_sigma2) - 1)]
    which = which.astype(np.int64)
    max_count = int(np.bincount(which, minlength=1).max())
    o_max = adaptive_o_max(max_count, O_MAX, cap=O_CAP)
    dropped = count_obs_drops(which, len(lm_ids), o_max)
    if dropped:
        _LOG.warning("global BA dropped %d observations beyond o_max=%d", dropped, o_max)

    dev = smap.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    prob = BAProblem(
        poses=t(smap.hview("kf_pose")[cams]),
        points=t(smap.hview("lm_pos")[lm_ids]),
        obs_cam=t(cam_slot[kf_idx]),
        obs_point=t(which),
        obs_uv=t(smap.hview("kf_xy")[kf_idx, feat_idx].astype(np.float32)),
        obs_inv_sigma2=t(inv_s2.astype(np.float32)),
        obs_mask=torch.ones(len(which), dtype=torch.bool, device=dev),
        point_obs=t(build_point_obs(which, len(lm_ids), o_max).astype(np.int64)),
        fixed_cam=t(np.isin(cams, list(fixed_kfs))),
        K=K,
    )
    poses_new, points_new, chi2 = bundle_adjustment(prob, iterations=ITERATIONS)
    smap.set_kf_poses(cams, poses_new.cpu().numpy())
    smap.set_landmark_positions(lm_ids, points_new.cpu().numpy())
    bad = chi2.cpu().numpy() > 5.991
    if bad.any():
        smap.scrub_observations(kf_idx[bad], feat_idx[bad])
    return len(cams), len(lm_ids), len(which)
