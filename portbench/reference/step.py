"""The fused steady-state tracking step of the plain reference: a frozen
copy of the port's ``FusedSteadyStep`` (``slam/tracking.py``) with its
matcher (``frontend/matcher.py::search_by_projection``) and pose-only
optimisation (``pose_opt.py``), plain torch.

``fused_step`` works the step out again from the same inputs the timed
path's step received: the frame as uploaded (8.8 fixed point), the map's
landmark tables and the id lists, the last pose and the velocity. It
extracts with ``extract`` in float32 (the precision the kernels keep) and
matches and optimises in ``dtype`` (float64 for the reference).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.extract import extract, level_budgets, undistort_points
from portbench.reference.pose_opt import pose_optimization

LOCAL_MAP_MAX = 4096  # the step's padded local-map landmark budget


class Frame(NamedTuple):
    xy: torch.Tensor  # (N, 2) undistorted pixels
    octave: torch.Tensor  # (N,) int64
    valid: torch.Tensor  # (N,) bool
    desc_pm1: torch.Tensor  # (N, 256) int8 ±1


TH_HIGH = 100  # max Hamming distance of a match


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


def hamming_matrix(pm1_a: torch.Tensor, pm1_b: torch.Tensor) -> torch.Tensor:
    """(N, 256) int8 ±1, ([B,] M, 256) int8 ±1 -> ([B,] N, M) int32 Hamming
    distances.

    The dot product runs in float32, which is exact for ±1 sums of 256
    terms (TF32 is off package-wide); an int8 product would wrap on the CPU.
    """
    dot = pm1_a.to(torch.float32) @ pm1_b.to(torch.float32).transpose(-1, -2)
    return (256 - dot.to(torch.int32)) // 2


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


def _obs_from_matches(n_features: int, matches, ids, lm_pos):
    """Per frame feature: the global id and position of the landmark matched
    to it (the highest matching point index wins), and whether it has one."""
    n_set = matches.shape[0]
    point = torch.arange(n_set, dtype=torch.int64, device=matches.device)
    obs_loc = torch.full((n_features,), -1, dtype=torch.int64, device=matches.device)
    obs_loc.scatter_reduce_(
        0, torch.clamp(matches.long(), min=0), torch.where(matches >= 0, point, -1),
        reduce="amax", include_self=True,
    )
    has = obs_loc >= 0
    sel = ids[torch.clamp(obs_loc, min=0)]
    return torch.where(has, sel, -1), lm_pos[sel], has




def fused_step(settings: dict, image_u16: torch.Tensor, packed_ids, velocity, last_pose, lm_pos, lm_desc, lm_valid,
               lm_oct, lm_normal, lm_mind, lm_maxd, dtype=torch.float64):
    """The step on the inputs the timed path's step received. ``settings``:
    the configuration's camera and extractor settings. Returns (Tcw (4, 4),
    obs (N,) landmark id per inlier feature or -1, ok)."""
    dev = image_u16.device
    n, n_levels, sf = settings["n_features"], settings["n_levels"], settings["scale_factor"]
    feats = extract(image_u16.to(torch.float32) * (1.0 / 256.0), n, n_levels, sf, settings["ini_th_fast"],
                    settings["min_th_fast"])
    K = torch.tensor([[settings["fx"], 0.0, settings["cx"]], [0.0, settings["fy"], settings["cy"]],
                      [0.0, 0.0, 1.0]], dtype=dtype, device=dev)
    dist = tuple(float(settings[k]) for k in ("k1", "k2", "p1", "p2", "k3"))
    xy = feats.xy_raw.to(dtype)
    if any(abs(d) > 1e-12 for d in dist):
        xy = undistort_points(K, dist, xy)
    pm1 = feats.bits.to(torch.int8) * 2 - 1
    frame = Frame(xy=xy, octave=feats.octave, valid=feats.valid, desc_pm1=pm1)
    scale_factors = torch.tensor([sf**i for i in range(n_levels)], dtype=dtype, device=dev)
    inv_s2 = 1.0 / scale_factors[torch.clamp(frame.octave, 0, n_levels - 1)] ** 2
    F = sum(level_budgets(2 * n, n_levels, sf))
    lm_pos, lm_normal = lm_pos.to(dtype), lm_normal.to(dtype)
    lm_mind, lm_maxd = lm_mind.to(dtype), lm_maxd.to(dtype)
    velocity, last_pose = velocity.to(dtype), last_pose.to(dtype)

    ids = packed_ids.long()
    mm_ids, loc_ids = ids[:F], ids[F : F + LOCAL_MAP_MAX]
    mm_n, loc_n = ids[F + LOCAL_MAP_MAX], ids[F + LOCAL_MAP_MAX + 1]
    pred = velocity @ last_pose
    arange = torch.arange(max(F, LOCAL_MAP_MAX), device=dev)
    v1 = (arange[:F] < mm_n) & lm_valid[mm_ids]
    p1, d1, o1 = lm_pos[mm_ids], lm_desc[mm_ids], lm_oct[mm_ids]
    m15 = search_by_projection(p1, d1, v1, o1, pred, frame, K, 15.0, scale_factors)[0]
    m30 = search_by_projection(p1, d1, v1, o1, pred, frame, K, 30.0, scale_factors)[0]
    m1 = torch.where(torch.sum(m15 >= 0) >= 20, m15, m30)
    n_feat = xy.shape[0]
    _, Xw1, has1 = _obs_from_matches(n_feat, m1, mm_ids, lm_pos)
    Tcw1, _, n1 = pose_optimization(pred, Xw1, frame.xy, inv_s2, has1 & frame.valid, K)
    ok1 = (torch.sum(m1 >= 0) >= 20) & (n1 >= 10)
    Tcw1 = torch.where(ok1, Tcw1, pred)
    v2 = (arange[:LOCAL_MAP_MAX] < loc_n) & lm_valid[loc_ids]
    m2 = search_by_projection(
        lm_pos[loc_ids], lm_desc[loc_ids], v2, lm_oct[loc_ids], Tcw1, frame, K, 4.0, scale_factors,
        pts_normal=lm_normal[loc_ids], pts_min_dist=lm_mind[loc_ids], pts_max_dist=lm_maxd[loc_ids],
    )[0]
    obs2, Xw2, has2 = _obs_from_matches(n_feat, m2, loc_ids, lm_pos)
    Tcw2, inl2, n2 = pose_optimization(Tcw1, Xw2, frame.xy, inv_s2, has2 & frame.valid, K)
    return Tcw2, torch.where(inl2, obs2, -1), bool(ok1 & (n2 >= 30))


def reprojection_gap_px(T_a: torch.Tensor, T_b: torch.Tensor, Xw: torch.Tensor, K: torch.Tensor) -> float:
    """Root mean square, over the points ``Xw`` (M, 3), of the distance in
    pixels between their projections through the poses ``T_a`` and
    ``T_b`` (float64)."""
    def proj(T):
        pc = Xw.double() @ T.double()[:3, :3].T + T.double()[:3, 3]
        z = torch.clamp(pc[:, 2], min=1e-9)
        return torch.stack([K[0, 0] * pc[:, 0] / z + K[0, 2], K[1, 1] * pc[:, 1] / z + K[1, 2]], -1)

    if Xw.shape[0] == 0:
        return 0.0
    d = proj(T_a) - proj(T_b)
    return float(torch.sqrt(torch.mean(torch.sum(d * d, dim=-1))))

