"""SE(3)/SO(3) exponential maps, batched torch.

Port of ``orbslam_in_practice_tpu/geometry/se3.py``. Tangent = [rho,
phi]: translation first, rotation second. All functions broadcast over
leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye3(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation, with
    Taylor-stable coefficients near theta = 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO(3): the exp_se3 translation coupling."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    W = hat(w)
    return _eye3(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) tangent [rho, phi] -> (..., 4, 4) SE3 matrix."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = (_so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return make_se3(exp_so3(phi), t)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle, by atan2 (finite at the
    identity), with a diagonal-extraction branch near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1
    )
    sin_t = 0.5 * torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * torch.clamp(sin_t, min=_EPS)))
    w_generic = scale[..., None] * v
    near_pi = theta > math.pi - 1e-3
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_t[..., None]) / torch.clamp(1.0 - cos_t[..., None], min=_EPS), min=0.0
    )
    sign = torch.where(v >= 0, 1.0, -1.0)
    w_pi = theta[..., None] * torch.sqrt(axis2) * sign
    return torch.where(near_pi[..., None], w_pi, w_generic)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) SE3 -> (..., 6) tangent [rho, phi]."""
    phi = log_so3(T[..., :3, :3])
    rho = torch.linalg.solve(_so3_left_jacobian(phi), T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> its inverse [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_se3(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) as (w, x, y, z), normalised here -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z),
    w >= 0: of the four candidate formulas (one per largest diagonal term),
    each batch entry takes its own by ``torch.where``."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1) / torch.sqrt(torch.clamp(4.0 * t, min=_EPS))[..., None]

    q0 = cand(1.0 + tr, 1.0 + tr, m21 - m12, m02 - m20, m10 - m01)
    q1 = cand(1.0 + m00 - m11 - m22, m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    q2 = cand(1.0 + m11 - m00 - m22, m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21)
    q3 = cand(1.0 + m22 - m00 - m11, m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11)
    c0 = (tr > 0)[..., None]
    c1 = ((m00 > m11) & (m00 > m22))[..., None]
    c2 = (m11 > m22)[..., None]
    q = torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) (or (..., 3))."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.dim() == T.dim() - 1:  # (..., N, 3) with T (..., 4, 4)
        return pts @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ pts[..., None])[..., 0] + t
