"""Relocalisation: EPnP-RANSAC against the keyframe database.

Port of ``orbslam_in_practice_tpu/slam/relocalization.py``. A lost frame's
global descriptor ranks every keyframe; the top ``N_CAND`` join the
``N_RECENT`` newest keyframes in a shortlist, which one batched
frame-to-keyframe match (ratio 0.75) scores. Candidates are tried in order
of their match count (>= 15): EPnP over ``N_HYP`` minimal sets of 6 at
once, >= 12 RANSAC inliers, then pose optimisation, which must keep >= 25
inliers.

The keyframes' global descriptors stay on the host (the map's ``kf_gdesc``
is host-only) and the ranking is done there: at most k_max x 256 floats, a
matvec of microseconds, on a path that reads its match counts to the host
anyway; a device copy would cost a row upload at every keyframe insertion
for a table only this rare path and loop detection read. The ranking breaks
ties to the lower slot, as ``lax.top_k`` does.

The reference draws its RANSAC samples with ``jax.random.choice`` keyed
``1 + ci`` for the ci-th candidate tried; here they are given
(``sample_idx[ci]``) or drawn from a ``torch.Generator`` seeded ``1 + ci``.
The path reads counts on the host (one copy per candidate), as the
reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.frontend.matcher import search_frame_to_kf
from orbslam_in_practice_tpu_torch.geometry.epnp import epnp
from orbslam_in_practice_tpu_torch.optim.pose_opt import pose_optimization
from orbslam_in_practice_tpu_torch.slam.initializer import ransac_samples
from orbslam_in_practice_tpu_torch.slam.map import _host
from orbslam_in_practice_tpu_torch.slam.place_recognition import global_descriptor

N_HYP = 64  # RANSAC hypotheses, one batch
MIN_SET = 6
N_CAND = 5  # retrieved shortlist size
N_RECENT = 3  # newest keyframes force-joined to the shortlist
NN_RATIO = 0.75
MIN_MATCHES = 15  # a candidate's matches (and landmark-bearing features) to try it
MIN_RANSAC_INLIERS = 12
MIN_INLIERS = 25  # after pose optimisation
CHI2 = 5.991


def _retrieve_candidates(frame, smap, forced: np.ndarray):
    """The shortlist: ``forced`` keyframes, then the N_CAND most similar by
    global descriptor among valid keyframes with >= MIN_MATCHES
    landmark-bearing features, each matched to the frame in one batch.
    Returns host (cand_ids (C,), matches (C, N), counts (C,) int32)."""
    fv = smap.hview("kf_feat_valid") & (smap.kf_obs_host() >= 0)
    gf = _host(global_descriptor(frame.desc_pm1, frame.valid))
    sims = smap.hview("kf_gdesc") @ gf
    sims = np.where(smap.kf_valid_host() & (fv.sum(axis=1) >= MIN_MATCHES), sims, -np.inf)
    cand = np.concatenate([forced, np.argsort(-sims, kind="stable")[:N_CAND]]).astype(np.int64)
    dev = smap.device
    idx = torch.from_numpy(cand).to(dev)
    matches = search_frame_to_kf(
        frame, smap.kf_xy[idx], smap.kf_angle[idx], smap.kf_desc_pm1[idx], torch.from_numpy(fv[cand]).to(dev),
        nn_ratio=NN_RATIO,
    )
    m_h = _host(matches)
    return cand, m_h, (m_h >= 0).sum(axis=1).astype(np.int32)


def epnp_ransac(pw, uv, inv_s2, valid, K, sample_idx=None, generator=None):
    """EPnP on N_HYP minimal sets at once, each scored on every valid
    correspondence by the per-octave chi2 gate (e2 * inv_s2 < 5.991, depth >
    0). pw (N, 3), uv (N, 2), inv_s2 (N,), valid (N,) bool; sample_idx
    optional (N_HYP, MIN_SET) indices, else drawn from ``generator``.
    Returns the best hypothesis' (R, t, inlier count), the first on ties."""
    if sample_idx is None:
        sample_idx = ransac_samples(valid, generator, N_HYP, MIN_SET)
    sample_idx = torch.as_tensor(sample_idx, device=pw.device).long()
    w = torch.zeros((N_HYP, pw.shape[0]), dtype=pw.dtype, device=pw.device).scatter_(1, sample_idx, 1.0)
    R, t, _ = epnp(pw, uv, K, w=w)
    pc = pw @ R.transpose(-1, -2) + t[:, None, :]
    z = torch.clamp(pc[..., 2], min=1e-9)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    n_inl = torch.sum(valid & (e2 * inv_s2 < CHI2) & (pc[..., 2] > 0), dim=-1)
    best = torch.argmax(n_inl)
    return R[best], t[best], n_inl[best]


def relocalize(tracker, frame, sample_idx=None):
    """Try to relocalise a lost frame against the keyframe database.

    tracker: has ``map``, ``K``, ``inv_level_sigma2`` (per octave, on the
    map's device) and ``cfg.n_levels``. sample_idx: optional sequence whose
    ci-th entry holds the (N_HYP, MIN_SET) RANSAC samples of the ci-th
    candidate in trial order.

    Returns (ok, Tcw (4, 4) numpy, obs (N,) int32 landmark per feature,
    n_inliers, keyframe slot).
    """
    smap = tracker.map
    if smap.n_kf_active() == 0:
        return False, None, None, 0, -1
    recent = smap.valid_keyframes_by_seq()[-N_RECENT:][::-1]
    forced = np.full(N_RECENT, int(recent[0]), np.int64)
    forced[: len(recent)] = recent
    cand, matches, counts = _retrieve_candidates(frame, smap, forced)
    order = np.argsort(-counts)
    dev = smap.device
    octave = torch.clamp(frame.octave.long(), 0, tracker.cfg.n_levels - 1)
    inv_s2 = tracker.inv_level_sigma2[octave]
    lm_pos_h = smap.hview("lm_pos")
    frame_xy_h = _host(frame.xy)
    n_pad = frame.n_features
    tried = set()
    for ci, oi in enumerate(order):
        if counts[oi] < MIN_MATCHES:
            break  # sorted: the rest match fewer
        kf = int(cand[oi])
        if kf in tried:  # the forced and retrieved lists may overlap
            continue
        tried.add(kf)
        sel = np.nonzero(matches[oi] >= 0)[0]
        lm_ids = smap.kf_obs_host()[kf][matches[oi][sel]]
        pw = np.zeros((n_pad, 3), np.float32)
        uv = np.zeros((n_pad, 2), np.float32)
        valid = np.zeros(n_pad, bool)
        pw[sel] = lm_pos_h[lm_ids]
        uv[sel] = frame_xy_h[sel]
        valid[sel] = True
        gen = None
        if sample_idx is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(1 + ci)
        R, t, n_inl = epnp_ransac(
            torch.from_numpy(pw).to(dev), torch.from_numpy(uv).to(dev), inv_s2, torch.from_numpy(valid).to(dev),
            tracker.K, None if sample_idx is None else sample_idx[ci], gen,
        )
        if int(n_inl) < MIN_RANSAC_INLIERS:
            continue
        Tcw0 = torch.eye(4, dtype=torch.float32, device=dev)
        Tcw0[:3, :3] = R
        Tcw0[:3, 3] = t
        obs = np.full(n_pad, -1, np.int32)
        obs[sel] = lm_ids
        obs_t = torch.from_numpy(obs.astype(np.int64)).to(dev)
        Tcw, inlier, n_in, _ = pose_optimization(
            Tcw0, smap.lm_pos[torch.clamp(obs_t, min=0)], frame.xy, inv_s2, (obs_t >= 0) & frame.valid, tracker.K
        )
        n_in = int(n_in)
        if n_in < MIN_INLIERS:
            continue
        obs[~_host(inlier)] = -1
        return True, _host(Tcw), obs, n_in, kf
    return False, None, None, 0, -1
