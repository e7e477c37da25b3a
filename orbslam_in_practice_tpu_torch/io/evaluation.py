"""ATE evaluation: Sim(3)-aligned RMSE against ground truth.

Port of ``orbslam_in_practice_tpu/io/evaluation.py`` (host numpy): align
the estimated camera centres to the ground truth with Horn's closed-form
similarity (monocular scale is unobservable) and report the RMSE.
"""

from __future__ import annotations

import numpy as np


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=q.dtype,
    )


def horn_sim3(p1: np.ndarray, p2: np.ndarray, with_scale: bool = True):
    """Closed-form similarity p2 ~ s R p1 + t of (N, 3) point sets (Horn's
    quaternion method). Returns (s, R (3, 3), t (3,))."""
    c1, c2 = p1.mean(axis=0), p2.mean(axis=0)
    q1, q2 = p1 - c1, p2 - c2
    M = q1.T @ q2
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = M
    N = np.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ],
        dtype=p1.dtype,
    )
    R = _quat_to_rot(np.linalg.eigh(N)[1][:, -1])  # max-eigenvalue eigenvector
    if with_scale:
        s = float(np.sum(q2 * (q1 @ R.T)) / max(float(np.sum(q1 * q1)), 1e-12))
    else:
        s = 1.0
    return s, R, c2 - s * (R @ c1)


def ate_rmse(est: list, gt_positions: np.ndarray, gt_ids: np.ndarray | None = None, align_scale: bool = True):
    """ATE RMSE of a trajectory [(frame_id, ts, Tcw or None), ...] against
    ground-truth camera centres (T, 3) indexed by frame id (or by gt_ids).

    Returns (rmse, n_aligned, coverage_fraction).
    """
    ids, centers = [], []
    for fid, _, Tcw in est:
        if Tcw is None:
            continue
        ids.append(fid)
        centers.append(np.linalg.inv(Tcw)[:3, 3])
    if len(ids) < 3:
        return float("inf"), 0, 0.0
    ids = np.asarray(ids)
    centers = np.asarray(centers, np.float32)
    if gt_ids is None:
        gt_ids = np.arange(len(gt_positions))
    lookup = {int(g): i for i, g in enumerate(gt_ids)}
    keep = np.array([int(i) in lookup for i in ids])
    ids, centers = ids[keep], centers[keep]
    gt = np.asarray([gt_positions[lookup[int(i)]] for i in ids], np.float32)
    s, R, t = horn_sim3(centers, gt, with_scale=align_scale)
    err = np.linalg.norm(s * centers @ R.T + t - gt, axis=-1)
    return float(np.sqrt(np.mean(err**2))), len(ids), len(ids) / max(len(est), 1)
