"""Closed-form absolute orientation and similarity (Horn's quaternion method).

Port of ``orbslam_in_practice_tpu/geometry/sim3.py``: the eigenvector of
Horn's 4x4 N matrix with the largest eigenvalue is the rotation as a (w, x,
y, z) quaternion. Used by the loop closer's Sim3 RANSAC and by EPnP's last
step (rigid, ``with_scale=False``).

Every argument takes leading batch dimensions, which broadcast against each
other: one point set (N, 3) with (B, N) weight masks fits B hypotheses.
"""

from __future__ import annotations

import torch

from orbslam_in_practice_tpu_torch.geometry.se3 import quat_to_rot


def horn_sim3(
    p1: torch.Tensor,
    p2: torch.Tensor,
    w: torch.Tensor | None = None,
    with_scale: bool = True,
):
    """Closed-form similarity p2 ~ s R p1 + t.

    Args: p1, p2 (..., N, 3) corresponding points; w optional (..., N)
    weights or mask; with_scale False returns s = 1 (rigid).

    Returns (s (...,), R (..., 3, 3), t (..., 3)).
    """
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    w = w.to(p1.dtype)
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    c1 = torch.sum(p1 * w[..., None], dim=-2) / n
    c2 = torch.sum(p2 * w[..., None], dim=-2) / n
    q1 = (p1 - c1[..., None, :]) * w[..., None]
    q2 = (p2 - c2[..., None, :]) * w[..., None]

    M = q1.transpose(-1, -2) @ q2  # sum of q1_i q2_i^T
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
        ],
        dim=-2,
    )
    _, vecs = torch.linalg.eigh(N)
    R = quat_to_rot(vecs[..., :, -1])  # the largest eigenvalue's eigenvector

    if with_scale:
        # s = sum <q2, R q1> / sum |q1|^2 (Horn eq. 40); masked points add 0
        Rq1 = q1 @ R.transpose(-1, -2)
        s = torch.sum(q2 * Rq1, dim=(-1, -2)) / torch.clamp(torch.sum(q1 * q1, dim=(-1, -2)), min=1e-12)
    else:
        s = torch.ones(M.shape[:-2], dtype=p1.dtype, device=p1.device)
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return s, R, t
