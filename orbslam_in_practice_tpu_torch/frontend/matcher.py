"""Descriptor matching: dense masked Hamming with ORB-SLAM's gating rules.

Port of ``orbslam_in_practice_tpu/frontend/matcher.py``: windowed matching
for initialisation, projection matching, frame-to-keyframe matching,
epipolar matching of two keyframes' free features and matching of two
descriptor sets. The Hamming matrix is one
matrix product; window, octave, frustum and epipolar gates are masks on it;
unique assignment is a scatter-min over claimed features.

Every ``lax.top_k`` of the reference becomes a min over ``value * N +
index`` (ties to the lower index, as ``top_k`` breaks them), and every
``.at[].min`` a ``scatter_reduce_(reduce="amin", include_self=True)``.
``search_by_projection``, ``epipolar_match_kf`` and ``search_frame_to_kf``
take an optional leading batch dimension on the keyframe side (the
reference vmaps them over keyframes).
"""

from __future__ import annotations

import math

import torch

from orbslam_in_practice_tpu_torch.frontend.frame import Frame
from orbslam_in_practice_tpu_torch.ops.hamming import hamming_matrix

TH_LOW = 50  # max Hamming distance of a strict match
TH_HIGH = 100  # max Hamming distance of a match
HISTO_BINS = 30  # rotation-consistency histogram bins
INIT_WINDOW = 100  # initialisation search window, pixels
INIT_NN_RATIO = 0.9  # initialisation best / second-best ratio
KF_NN_RATIO = 0.7  # frame-to-keyframe best / second-best ratio, tracking
# keyframe-to-keyframe association in loop closing: all against all with no
# spatial window, so looser than TH_LOW / 0.75; the Sim3 RANSAC's pixel
# gates keep the precision
SETS_NN_RATIO = 0.9
_BIG = 1 << 20


def _row_keys(dist: torch.Tensor) -> torch.Tensor:
    n = dist.shape[-1]
    return dist.to(torch.int64) * n + torch.arange(n, device=dist.device)


def _min_by_row(dist: torch.Tensor):
    """The smallest entry of each row (last dim) and its column, ties to the
    lower column (as the reference's ``lax.top_k`` of the negation breaks
    them)."""
    n = dist.shape[-1]
    best = torch.amin(_row_keys(dist), dim=-1)
    return best // n, best % n


def _top2_by_row(dist: torch.Tensor):
    """(d1, column of d1, d2): the two smallest entries of each row, ties to
    the lower column, as ``lax.top_k(-dist, 2)`` gives them."""
    n = dist.shape[-1]
    two = torch.topk(_row_keys(dist), 2, dim=-1, largest=False).values
    return two[..., 0] // n, two[..., 0] % n, two[..., 1] // n


def _argmin_by_col(dist: torch.Tensor) -> torch.Tensor:
    """Row of the smallest entry of each column, ties to the lower row
    (``jnp.argmin(axis=0)``)."""
    return _min_by_row(dist.transpose(-1, -2))[1]


def _rotation_consistency(rot_diff: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """Keep matches whose angle difference falls in one of the 3 fullest
    histogram bins, dropping bins under 0.1 of the fullest. Batched over
    leading dims. Only the 3 largest bin counts matter, so bins that tie
    are kept or dropped together, as in the reference."""
    two_pi = 2.0 * math.pi
    m = torch.fmod(rot_diff, two_pi)  # floor mod, as jnp.mod computes it
    m = torch.where((m != 0) & (m < 0), m + two_pi, m)
    bins = torch.clamp((m / two_pi * HISTO_BINS).to(torch.int64), 0, HISTO_BINS - 1)
    hist = torch.zeros(matched.shape[:-1] + (HISTO_BINS,), dtype=torch.int64, device=matched.device)
    hist.scatter_add_(-1, bins, matched.to(torch.int64))
    top3 = torch.topk(hist, 3, dim=-1).values
    keep_bin = (hist[..., :, None] == top3[..., None, :]).any(dim=-1) & (hist > 0.1 * top3[..., :1])
    return matched & torch.gather(keep_bin, -1, bins)


def search_for_initialization(f1: Frame, f2: Frame, prev_xy: torch.Tensor | None = None) -> torch.Tensor:
    """Level-0 windowed matching for monocular initialisation.

    prev_xy: (N1, 2) search centres in f2 (default f1.xy). Returns (N1,)
    int32 index into f2 or -1: best within INIT_WINDOW pixels at distance
    <= TH_LOW, under INIT_NN_RATIO of the second best, mutually best,
    rotation-consistent.
    """
    if prev_xy is None:
        prev_xy = f1.xy
    dist = hamming_matrix(f1.desc_pm1, f2.desc_pm1)
    lvl0 = (f1.octave == 0)[:, None] & (f2.octave == 0)[None, :]
    validm = f1.valid[:, None] & f2.valid[None, :]
    dx = torch.abs(prev_xy[:, 0:1] - f2.xy[None, :, 0])
    dy = torch.abs(prev_xy[:, 1:2] - f2.xy[None, :, 1])
    in_win = (dx <= INIT_WINDOW) & (dy <= INIT_WINDOW)
    masked = torch.where(validm & lvl0 & in_win, dist, _BIG)

    d1, j_best, d2 = _top2_by_row(masked)
    ok = (d1 <= TH_LOW) & (d1.to(torch.float32) < INIT_NN_RATIO * d2.to(torch.float32))
    rows = torch.arange(f1.n_features, device=dist.device)
    ok = ok & (_argmin_by_col(masked)[j_best] == rows)
    ok = _rotation_consistency(f1.angle - f2.angle[j_best], ok)
    return torch.where(ok, j_best, -1).to(torch.int32)


def search_by_projection(
    pts_w: torch.Tensor,
    pts_desc_pm1: torch.Tensor,
    pts_valid: torch.Tensor,
    pts_octave: torch.Tensor,
    Tcw: torch.Tensor,
    frame: Frame,
    K: torch.Tensor,
    radius: float,
    scale_factors: torch.Tensor,
    pts_normal: torch.Tensor | None = None,
    pts_min_dist: torch.Tensor | None = None,
    pts_max_dist: torch.Tensor | None = None,
    max_th_dist: int = TH_HIGH,
):
    """Project world points into the frame and match in a radius window.

    Per point: positive depth, inside the frame's keypoint extents, and, with
    the landmark invariants, distance within [0.8 min, 1.2 max] and viewing
    cosine > 0.5 against the normal; then the min-Hamming feature within
    radius * scale_factor[predicted octave] pixels whose octave is within
    +-1 of the distance-predicted one (ORB-SLAM's PredictScale), at Hamming
    distance <= max_th_dist.

    Args: pts_w (M, 3); pts_desc_pm1 (M, 256) int8; pts_valid (M,) bool;
      pts_octave (M,) int32 (used when the invariants are absent); Tcw
      ([B,] 4, 4); frame fields ([B,] N, ...); radius in pixels; optional
      pts_normal (M, 3), pts_min_dist and pts_max_dist (M,). With a leading
      batch dim B on Tcw and the frame, the points are matched into each.

    Returns (matches ([B,] M) int32 feature index or -1, proj_uv ([B,] M, 2),
    in_image ([B,] M) bool).
    """
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    pc = pts_w @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = K[0, 0] * pc[..., 0] / z_safe + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z_safe + K[1, 2]
    proj = torch.stack([u, v], dim=-1)

    inf = torch.full_like(frame.xy[..., 0], float("inf"))
    min_x = torch.amin(torch.where(frame.valid, frame.xy[..., 0], inf), dim=-1, keepdim=True)
    max_x = torch.amax(torch.where(frame.valid, frame.xy[..., 0], -inf), dim=-1, keepdim=True)
    min_y = torch.amin(torch.where(frame.valid, frame.xy[..., 1], inf), dim=-1, keepdim=True)
    max_y = torch.amax(torch.where(frame.valid, frame.xy[..., 1], -inf), dim=-1, keepdim=True)
    in_image = (z > 0.0) & (u >= min_x) & (u <= max_x) & (v >= min_y) & (v <= max_y)

    cam_center = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    po = pts_w - cam_center[..., None, :]
    d = torch.sqrt(torch.sum(po * po, dim=-1))
    n_levels = scale_factors.shape[0]
    pred_octave = pts_octave.long()
    if pts_min_dist is not None and pts_max_dist is not None:
        in_image = in_image & (d >= 0.8 * pts_min_dist) & (d <= 1.2 * pts_max_dist)
        log_scale = torch.log(scale_factors[1] / scale_factors[0])
        ratio = torch.clamp(pts_max_dist, min=1e-9) / torch.clamp(d, min=1e-9)
        pred_octave = torch.clamp(
            torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale).long(), 0, n_levels - 1
        )
    if pts_normal is not None:
        view_cos = torch.sum(po * pts_normal, dim=-1) / torch.clamp(d, min=1e-9)
        in_image = in_image & (view_cos > 0.5)

    dist = hamming_matrix(pts_desc_pm1, frame.desc_pm1)  # ([B,] M, N)
    r_scaled = radius * scale_factors[torch.clamp(pred_octave, 0, n_levels - 1)]
    du = torch.abs(proj[..., :, 0:1] - frame.xy[..., None, :, 0])
    dv = torch.abs(proj[..., :, 1:2] - frame.xy[..., None, :, 1])
    in_win = (du <= r_scaled[..., None]) & (dv <= r_scaled[..., None])
    oct_ok = torch.abs(frame.octave[..., None, :].long() - pred_octave[..., :, None]) <= 1
    maskm = pts_valid[:, None] & in_image[..., None] & frame.valid[..., None, :] & in_win & oct_ok
    masked = torch.where(maskm, dist, torch.full_like(dist, _BIG))

    d1, j_best = _min_by_row(masked)
    ok = d1 <= max_th_dist

    # unique assignment: of several points claiming one feature keep the
    # min distance, then among equal distances the lowest point index
    m_idx = torch.arange(pts_valid.shape[0], device=pts_w.device)
    claim_shape = frame.valid.shape
    claim = torch.full(claim_shape, _BIG, dtype=torch.int64, device=pts_w.device)
    claim.scatter_reduce_(-1, j_best, torch.where(ok, d1, _BIG), reduce="amin", include_self=True)
    ok = ok & (torch.gather(claim, -1, j_best) == d1)
    first = torch.full(claim_shape, 1 << 30, dtype=torch.int64, device=pts_w.device)
    first.scatter_reduce_(
        -1, j_best, torch.where(ok, m_idx, 1 << 30), reduce="amin", include_self=True
    )
    ok = ok & (torch.gather(first, -1, j_best) == m_idx)
    return torch.where(ok, j_best, -1).to(torch.int32), proj, in_image


def search_frame_to_kf(
    frame: Frame,
    kf_xy: torch.Tensor,
    kf_angle: torch.Tensor,
    kf_desc_pm1: torch.Tensor,
    kf_has_lm: torch.Tensor,
    nn_ratio: float = KF_NN_RATIO,
) -> torch.Tensor:
    """Match the frame's features against a keyframe's landmark-bearing
    features (the role of ORB-SLAM's SearchByBoW): distance <= TH_LOW, ratio
    test at ``nn_ratio``, cross-check, rotation consistency. The keyframe
    arguments take an optional leading batch dim B (one lane per keyframe).
    Returns ([B,] N_frame) int32 index into the keyframe's features or -1."""
    dist = hamming_matrix(frame.desc_pm1, kf_desc_pm1)  # ([B,] N, F)
    maskm = frame.valid[:, None] & kf_has_lm[..., None, :]
    masked = torch.where(maskm, dist, _BIG)
    d1, j_best, d2 = _top2_by_row(masked)
    ok = (d1 <= TH_LOW) & (d1.to(torch.float32) < nn_ratio * d2.to(torch.float32))
    rows = torch.arange(frame.n_features, device=dist.device)
    ok = ok & (torch.gather(_argmin_by_col(masked), -1, j_best) == rows)
    ok = _rotation_consistency(frame.angle - torch.gather(kf_angle, -1, j_best), ok)
    return torch.where(ok, j_best, -1).to(torch.int32)


def match_descriptor_sets(
    desc_a_pm1: torch.Tensor,
    mask_a: torch.Tensor,
    desc_b_pm1: torch.Tensor,
    mask_b: torch.Tensor,
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
) -> torch.Tensor:
    """Masked matching of two descriptor sets (keyframe-to-keyframe
    association in loop closing): distance <= TH_HIGH, ratio test at
    SETS_NN_RATIO, cross-check, rotation consistency. Returns (A,) int32
    index into B or -1."""
    dist = hamming_matrix(desc_a_pm1, desc_b_pm1)
    masked = torch.where(mask_a[:, None] & mask_b[None, :], dist, _BIG)
    d1, j_best, d2 = _top2_by_row(masked)
    ok = (d1 <= TH_HIGH) & (d1.to(torch.float32) < SETS_NN_RATIO * d2.to(torch.float32))
    rows = torch.arange(desc_a_pm1.shape[0], device=dist.device)
    ok = ok & (_argmin_by_col(masked)[j_best] == rows)
    ok = _rotation_consistency(angle_a - angle_b[j_best], ok)
    return torch.where(ok, j_best, -1).to(torch.int32)


def epipolar_match_kf(
    xy1: torch.Tensor,
    desc1_pm1: torch.Tensor,
    free1: torch.Tensor,
    octave1: torch.Tensor,
    xy2: torch.Tensor,
    desc2_pm1: torch.Tensor,
    free2: torch.Tensor,
    octave2: torch.Tensor,
    F12: torch.Tensor,
    inv_level_sigma2: torch.Tensor,
    *,
    max_dist: torch.Tensor | int,
    angle1: torch.Tensor,
    angle2: torch.Tensor,
) -> torch.Tensor:
    """Epipolar-constrained matching of two keyframes' free features, for
    new-point triangulation.

    Args: xy1 (F1, 2), desc1_pm1 (F1, 256), free1, octave1 and angle1 (F1,)
      of the first keyframe; xy2, desc2_pm1, free2, octave2, angle2 of the second,
      each with an optional leading batch dim B (one lane per neighbour);
      F12 ([B,] 3, 3) with x2' F12 x1 = 0; inv_level_sigma2 (n_levels,);
      max_dist scalar or (B,).

    Returns ([B,] F1) int32 index into the second keyframe's features or -1.
    """
    dist = hamming_matrix(desc1_pm1, desc2_pm1)  # ([B,] F1, F2)
    h1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)  # (F1, 3)
    l2 = h1 @ F12.transpose(-1, -2)  # ([B,] F1, 3): epipolar lines in image 2
    num = (
        l2[..., :, None, 0] * xy2[..., None, :, 0]
        + l2[..., :, None, 1] * xy2[..., None, :, 1]
        + l2[..., :, None, 2]
    )
    den = l2[..., 0] ** 2 + l2[..., 1] ** 2
    d2_line = num * num / torch.clamp(den[..., None], min=1e-12)
    sig2 = 1.0 / inv_level_sigma2[torch.clamp(octave2.long(), 0, inv_level_sigma2.shape[0] - 1)]
    epi_ok = d2_line < 3.84 * sig2[..., None, :]
    oct_ok = torch.abs(octave1[:, None].long() - octave2[..., None, :].long()) <= 1
    maskm = free1[:, None] & free2[..., None, :] & epi_ok & oct_ok
    masked = torch.where(maskm, dist, _BIG)
    d1, j_best, d2 = _top2_by_row(masked)
    max_dist = torch.as_tensor(max_dist, device=dist.device)
    ok = (d1 <= max_dist[..., None]) & (d1.to(torch.float32) < 0.9 * d2.to(torch.float32))
    rows = torch.arange(xy1.shape[0], device=dist.device)
    ok = ok & (torch.gather(_argmin_by_col(masked), -1, j_best) == rows)
    # rotation consistency, applied only where the histogram has support
    # (>= 50 matches)
    filtered = _rotation_consistency(angle1 - torch.gather(angle2, -1, j_best), ok)
    ok = torch.where(torch.sum(ok, dim=-1, keepdim=True) >= 50, filtered, ok)
    return torch.where(ok, j_best, -1).to(torch.int32)


def fundamental_from_poses(T1w: torch.Tensor, T2w: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """F12 with x2' F12 x1 = 0 from world->camera poses ([B,] 4, 4):
    relative pose T21 = T2w @ inv(T1w)."""
    R1, t1 = T1w[..., :3, :3], T1w[..., :3, 3]
    R2, t2 = T2w[..., :3, :3], T2w[..., :3, 3]
    R21 = R2 @ R1.transpose(-1, -2)
    t21 = t2 - (R21 @ t1[..., None])[..., 0]
    z = torch.zeros_like(t21[..., 0])
    tx = torch.stack(
        [
            torch.stack([z, -t21[..., 2], t21[..., 1]], dim=-1),
            torch.stack([t21[..., 2], z, -t21[..., 0]], dim=-1),
            torch.stack([-t21[..., 1], t21[..., 0], z], dim=-1),
        ],
        dim=-2,
    )
    Kinv = torch.linalg.inv(K)
    return Kinv.T @ tx @ R21 @ Kinv
