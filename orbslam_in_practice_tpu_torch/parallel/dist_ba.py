"""Distributed bundle adjustment: landmarks sharded, cameras replicated.

Port of ``orbslam_in_practice_tpu/parallel/dist_ba.py``. Landmarks, with
their observations, are split into contiguous shards; camera poses are
replicated on every rank. Each LM iteration:

1. every rank assembles, over its local shards, the camera blocks of the
   normal equations (``Hcc``, ``b_c``), its landmarks' Schur off-diagonal
   terms (dense one-hot contractions up to ``DENSE_ASSEMBLY_MAX_CAMS``
   cameras, landmark chunks above) and the robust cost, and one
   ``all_reduce`` sums them over the ranks;
2. every rank solves the same reduced camera system;
3. landmarks are back-substituted locally, and a second ``all_reduce`` sums
   the new cost for the accept/reject, which stays on the device.

A rank's local shards are one landmark block (indices offset by shard), so
they are assembled in one pass: the sums over them are the sums over the
shards. The communication is independent of the landmark count. Without an
initialised process group (one process) no collective runs and the sums
are the same. Huber stays on, as in ``optim/ba.py``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from orbslam_in_practice_tpu_torch.geometry.se3 import exp_se3
from orbslam_in_practice_tpu_torch.optim.ba import (
    DENSE_ASSEMBLY_MAX_CAMS,
    BAProblem,
    _inv3x3,
    _total_cost,
    adaptive_o_max,
    build_normal_equations,
    build_point_obs,
    count_obs_drops,
    included_obs_mask,
    schur_offdiag_chunked,
)

O_MAX, O_CAP = 12, 24  # per-landmark observation budget of the map's BA
_LOG = logging.getLogger("orbslam_tpu_torch")


def partition_ba_problem(
    poses: np.ndarray,
    points: np.ndarray,
    obs_cam: np.ndarray,
    obs_point: np.ndarray,
    obs_uv: np.ndarray,
    obs_inv_sigma2: np.ndarray,
    fixed_cam: np.ndarray,
    K: np.ndarray,
    n_shards: int,
    o_max: int = O_MAX,
) -> BAProblem:
    """Reorder a BA problem into ``n_shards`` contiguous landmark blocks.

    Each observation goes to its landmark's shard; landmarks and
    observations are padded per shard to equal sizes. Returns a BAProblem
    of numpy arrays (the JAX package's, array for array) whose landmark and
    observation axes are ``n_shards`` blocks, with ``obs_point`` and
    ``point_obs`` local to each block."""
    n_lm = len(points)
    lm_per = -(-n_lm // n_shards)
    obs_shard = obs_point // lm_per
    o_per = max(int(np.bincount(obs_shard, minlength=n_shards).max()), 1)

    sh_cam = np.zeros((n_shards, o_per), np.int32)
    sh_pt = np.zeros((n_shards, o_per), np.int32)
    sh_uv = np.zeros((n_shards, o_per, 2), np.float32)
    sh_is2 = np.ones((n_shards, o_per), np.float32)
    sh_mask = np.zeros((n_shards, o_per), bool)
    sh_point_obs = np.full((n_shards, lm_per, o_max), -1, np.int32)
    for s in range(n_shards):
        sel = np.nonzero(obs_shard == s)[0]
        n = len(sel)
        sh_cam[s, :n] = obs_cam[sel]
        sh_pt[s, :n] = obs_point[sel] - s * lm_per  # local landmark index
        sh_uv[s, :n] = obs_uv[sel]
        sh_is2[s, :n] = obs_inv_sigma2[sel]
        sh_mask[s, :n] = True
        sh_point_obs[s] = build_point_obs(np.where(np.arange(o_per) < n, sh_pt[s], -1), lm_per, o_max)
    pts_pad = np.zeros((lm_per * n_shards, 3), np.float32)
    pts_pad[:n_lm] = points
    return BAProblem(
        poses=np.asarray(poses),
        points=pts_pad,
        obs_cam=sh_cam.reshape(-1),
        obs_point=sh_pt.reshape(-1),
        obs_uv=sh_uv.reshape(-1, 2),
        obs_inv_sigma2=sh_is2.reshape(-1),
        obs_mask=sh_mask.reshape(-1),
        point_obs=sh_point_obs.reshape(-1, o_max),
        fixed_cam=np.asarray(fixed_cam),
        K=np.asarray(K),
    )


def _local_problem(prob: BAProblem, mesh) -> BAProblem:
    """This rank's shards of a partitioned problem as one block of tensors
    on the mesh's device: landmark and observation indices offset by the
    shard's place in the block."""
    ls, n_sh = mesh.local_shards, mesh.n_shards
    lm_per = len(prob.points) // n_sh
    o_per = len(prob.obs_cam) // n_sh
    s0 = mesh.rank * ls

    def rows(a, per):
        return np.asarray(a)[s0 * per : (s0 + ls) * per]

    obs_point = rows(prob.obs_point, o_per).astype(np.int64) + np.repeat(np.arange(ls), o_per) * lm_per
    po = rows(prob.point_obs, lm_per).astype(np.int64)
    point_obs = np.where(po >= 0, po + np.repeat(np.arange(ls), lm_per)[:, None] * o_per, -1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)  # noqa: E731
    return BAProblem(
        poses=t(np.asarray(prob.poses, np.float32)),
        points=t(rows(prob.points, lm_per)),
        obs_cam=t(rows(prob.obs_cam, o_per).astype(np.int64)),
        obs_point=t(obs_point),
        obs_uv=t(rows(prob.obs_uv, o_per)),
        obs_inv_sigma2=t(rows(prob.obs_inv_sigma2, o_per)),
        obs_mask=t(rows(prob.obs_mask, o_per)),
        point_obs=t(point_obs),
        fixed_cam=t(np.asarray(prob.fixed_cam, bool)),
        K=t(np.asarray(prob.K, np.float32)),
    )


def _all_reduce(mesh, *tensors) -> list:
    """The sums of ``tensors`` over the ranks, in one collective (none
    without a process group)."""
    if not mesh.distributed:
        return list(tensors)
    flat = torch.cat([x.reshape(-1) for x in tensors])
    dist.all_reduce(flat)
    out, i = [], 0
    for x in tensors:
        out.append(flat[i : i + x.numel()].view(x.shape))
        i += x.numel()
    return out


def _schur_offdiag(Hpp, b_p, Wg, cam_g, pv, n_cam, lam):
    """This rank's landmarks' terms of the reduced camera system: (Hpp^-1
    (L, 3, 3), -sum W Hpp^-1 W^T (K, K, 6, 6), -sum W Hpp^-1 b_p (K, 6))."""
    dtype, device = Hpp.dtype, Hpp.device
    eye3 = torch.eye(3, dtype=dtype, device=device)
    Hpp_inv = _inv3x3(Hpp + lam * Hpp * eye3 + 1e-8 * eye3)
    T = Wg @ Hpp_inv[:, None]  # (L, O_max, 6, 3)
    contrib = (T @ b_p[:, None, :, None])[..., 0]  # (L, O_max, 6)
    if n_cam <= DENSE_ASSEMBLY_MAX_CAMS:
        E = ((cam_g[..., None] == torch.arange(n_cam, device=device)) & pv[..., None]).to(dtype)
        A = torch.einsum("lok,loij->lkij", E, T)
        B = torch.einsum("lok,loij->lkij", E, Wg)
        return Hpp_inv, -torch.einsum("lkiz,lqjz->kqij", A, B), -torch.einsum("lok,loi->ki", E, contrib)
    S_neg, b_neg = schur_offdiag_chunked(T, Wg, contrib, cam_g, pv, n_cam)
    return Hpp_inv, S_neg, b_neg


def _solve_cameras(Hcc, b_c, S_off, b_off, fixed_cam, lam):
    """Damp the summed camera blocks, fix the gauge and solve: delta_c (K, 6)."""
    dtype, device = Hcc.dtype, Hcc.device
    n_cam = Hcc.shape[0]
    eye6 = torch.eye(6, dtype=dtype, device=device)
    cam_eye = torch.eye(n_cam, dtype=dtype, device=device)[:, :, None, None]
    S = S_off + cam_eye * (Hcc + lam * Hcc * eye6 + 1e-8 * eye6)[:, None]
    free = (~fixed_cam).to(dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S + cam_eye * (eye6 * fixed_cam.to(dtype)[:, None, None])[:, None]
    b_red = (b_c + b_off) * free[:, None]
    S_mat = S.permute(0, 2, 1, 3).reshape(n_cam * 6, n_cam * 6)
    return torch.linalg.solve_ex(S_mat, b_red.reshape(-1))[0].reshape(n_cam, 6)


def _problem_cost(local: BAProblem, mesh, poses, points) -> torch.Tensor:
    w_obs = (local.obs_mask & included_obs_mask(local.point_obs, local.obs_cam.shape[0])).to(poses.dtype)
    return _all_reduce(mesh, _total_cost(poses, points, local, w_obs))[0]


def dist_bundle_adjustment(prob: BAProblem, mesh, iterations: int = 10):
    """LM over a partitioned problem (``partition_ba_problem``, split into
    ``mesh.n_shards`` blocks); this rank works on its ``mesh.local_shards``.

    Returns (poses (K, 4, 4), points (all shards' landmarks, padded, 3)) on
    ``mesh.device``, the same on every rank: the landmark blocks are
    gathered at the end."""
    local = _local_problem(prob, mesh)
    n_cam = local.poses.shape[0]
    w_obs = (local.obs_mask & included_obs_mask(local.point_obs, local.obs_cam.shape[0])).to(local.poses.dtype)
    poses, points = local.poses, local.points
    lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
    free = (~local.fixed_cam)[:, None].to(poses.dtype)
    for _ in range(iterations):
        Hcc, b_c, Hpp, b_p, Wg, cam_g, pv, _ = build_normal_equations(poses, points, local)
        Hpp_inv, S_loc, b_loc = _schur_offdiag(Hpp, b_p, Wg, cam_g, pv, n_cam, lam)
        cost_loc = _total_cost(poses, points, local, w_obs)
        Hcc, b_c, S_off, b_off, cost_old = _all_reduce(mesh, Hcc, b_c, S_loc, b_loc, cost_loc)
        delta_c = _solve_cameras(Hcc, b_c, S_off, b_off, local.fixed_cam, lam)
        dc_g = delta_c[cam_g] * pv[..., None].to(poses.dtype)
        delta_p = (Hpp_inv @ (b_p - torch.einsum("loij,loi->lj", Wg, dc_g))[..., None])[..., 0]
        poses_new = exp_se3(delta_c * free) @ poses
        points_new = points + delta_p
        (cost_new,) = _all_reduce(mesh, _total_cost(poses_new, points_new, local, w_obs))
        ok = torch.isfinite(cost_new) & (cost_new < cost_old)
        poses = torch.where(ok, poses_new, poses)
        points = torch.where(ok, points_new, points)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    if mesh.distributed and mesh.world_size > 1:
        blocks = [torch.empty_like(points) for _ in range(mesh.world_size)]
        dist.all_gather(blocks, points.contiguous())
        points = torch.cat(blocks)
    return poses, points


def map_problem(smap, K, inv_level_sigma2: np.ndarray, n_shards: int, fixed_kfs=(0, 1)):
    """The whole map's BA problem, partitioned into ``n_shards``: every
    valid keyframe (those in ``fixed_kfs`` fixed) and landmark, and their
    observations. Returns (problem, keyframe slots, landmark ids)."""
    n_kf = smap.n_kf
    valid_kf = smap.kf_valid_host()[:n_kf]
    cams = [int(k) for k in range(n_kf) if valid_kf[k]]
    lm_ids = np.nonzero(smap.lm_valid_host())[0]
    if len(cams) < 2 or len(lm_ids) == 0:
        return None, cams, lm_ids
    kf_idx, feat_idx, which = smap.observations_of(lm_ids)
    keep = np.isin(kf_idx, cams)
    kf_idx, feat_idx, which = kf_idx[keep], feat_idx[keep], which[keep]
    cam_slot = np.full(smap.k_max, -1, np.int64)
    cam_slot[cams] = np.arange(len(cams))
    obs_oct = smap.hview("kf_octave")[kf_idx, feat_idx]
    inv_s2 = inv_level_sigma2[np.clip(obs_oct, 0, len(inv_level_sigma2) - 1)].astype(np.float32)
    o_max = adaptive_o_max(int(np.bincount(which, minlength=1).max()), O_MAX, cap=O_CAP)
    dropped = count_obs_drops(which, len(lm_ids), o_max)
    if dropped:
        _LOG.warning("distributed BA dropped %d observations beyond o_max=%d", dropped, o_max)
    K = K.cpu().numpy() if isinstance(K, torch.Tensor) else np.asarray(K)
    prob = partition_ba_problem(
        smap.hview("kf_pose")[cams], smap.hview("lm_pos")[lm_ids], cam_slot[kf_idx].astype(np.int32),
        which.astype(np.int32), smap.hview("kf_xy")[kf_idx, feat_idx].astype(np.float32), inv_s2,
        np.isin(cams, list(fixed_kfs)), K.astype(np.float32), n_shards=n_shards, o_max=o_max,
    )
    return prob, cams, lm_ids


def problem_cost(prob: BAProblem, mesh) -> float:
    """The robust cost of a partitioned problem at its own poses and
    points, summed over the ranks."""
    local = _local_problem(prob, mesh)
    return float(_problem_cost(local, mesh, local.poses, local.points))


def distributed_global_ba(smap, K, inv_level_sigma2: np.ndarray, mesh, iterations: int = 10, fixed_kfs=(0, 1)):
    """Full-map BA over the mesh, straight from a SlamMap: partition the
    map's landmarks into ``mesh.n_shards`` shards, run the all-reduced LM
    loop, write the refined poses and landmarks back (on every rank).
    K: (3, 3) intrinsics (numpy or tensor). Returns (n_cams, n_points,
    n_obs)."""
    prob, cams, lm_ids = map_problem(smap, K, inv_level_sigma2, mesh.n_shards, fixed_kfs)
    if prob is None:
        return 0, 0, 0
    poses, points = dist_bundle_adjustment(prob, mesh, iterations=iterations)
    smap.set_kf_poses(cams, poses.cpu().numpy())
    smap.set_landmark_positions(lm_ids, points.cpu().numpy()[: len(lm_ids)])
    return len(cams), len(lm_ids), int(prob.obs_mask.sum())
