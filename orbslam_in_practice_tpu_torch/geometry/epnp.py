"""EPnP: perspective-n-point from 3D-2D correspondences, batched.

Port of ``orbslam_in_practice_tpu/geometry/epnp.py``: 4 control points from
the centroid and principal axes, barycentric coordinates, the null space of
the 12x12 M^T M (``eigh``), the L (6x10) / rho system, three beta
initialisations each refined by 5 Gauss-Newton steps, the depth-sign fix,
Horn's rigid alignment, and the candidate with the least reprojection error.

Every function takes leading batch dimensions. The reference vmaps ``epnp``
over RANSAC hypotheses given as weight masks; here the hypotheses are a
leading dim of ``w`` (B, N) against one shared correspondence set.
"""

from __future__ import annotations

import torch

from orbslam_in_practice_tpu_torch.geometry.sim3 import horn_sim3

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))  # control-point distances
GN_ITERATIONS = 5


def _control_points(pw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Centroid + principal axes scaled by their spread: (..., N, 3), (..., N)
    -> (..., 4, 3)."""
    n = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    c0 = torch.sum(pw * w[..., None], dim=-2) / n[..., None]
    q = (pw - c0[..., None, :]) * w[..., None]
    cov = q.transpose(-1, -2) @ q / n[..., None, None]
    vals, vecs = torch.linalg.eigh(cov)  # ascending
    axes = vecs.transpose(-1, -2) * torch.sqrt(torch.clamp(vals, min=1e-10))[..., :, None]
    return torch.cat([c0[..., None, :], c0[..., None, :] + axes.flip(-2)], dim=-2)


def _barycentric(pw: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points, (..., 4, 3) control points -> (..., N, 4) alphas."""
    B = (cw[..., 1:, :] - cw[..., :1, :]).transpose(-1, -2)
    Binv = torch.linalg.inv(B + 1e-12 * torch.eye(3, dtype=B.dtype, device=B.device))
    a123 = (pw - cw[..., :1, :]) @ Binv.transpose(-1, -2)
    return torch.cat([1.0 - torch.sum(a123, dim=-1, keepdim=True), a123], dim=-1)


def _build_M(alphas: torch.Tensor, uv: torch.Tensor, K: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) alphas, (..., N, 2) pixels -> M (..., 2N, 12), rows weighted."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = uv[..., 0], uv[..., 1]
    z = torch.zeros_like(alphas[..., 0])
    ru = torch.cat([torch.stack([alphas[..., j] * fx, z, alphas[..., j] * (cx - u)], dim=-1) for j in range(4)], -1)
    rv = torch.cat([torch.stack([z, alphas[..., j] * fy, alphas[..., j] * (cy - v)], dim=-1) for j in range(4)], -1)
    return torch.cat([ru * w[..., None], rv * w[..., None]], dim=-2)


def _dists2(c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) -> (..., 6) squared pairwise distances."""
    return torch.stack([torch.sum((c[..., i, :] - c[..., j, :]) ** 2, dim=-1) for i, j in _PAIRS], dim=-1)


def _L_and_rho(V: torch.Tensor, cw: torch.Tensor):
    """L (..., 6, 10) and rho (..., 6) of the beta system. V (..., 4, 12):
    the null-space vectors as rows. L's columns order the products
    [b1^2, b1b2, b2^2, b1b3, b2b3, b3^2, b1b4, b2b4, b3b4, b4^2]."""
    cv = V.reshape(V.shape[:-1] + (4, 3))  # (..., vec, ctrl, 3)
    dv = torch.stack([cv[..., i, :] - cv[..., j, :] for i, j in _PAIRS], dim=-2)  # (..., 4, 6, 3)

    def dot(a, b):
        return torch.sum(dv[..., a, :, :] * dv[..., b, :, :], dim=-1)

    L = torch.stack(
        [dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2), dot(2, 2),
         2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3)],
        dim=-1,
    )
    return L, _dists2(cw)


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Regularised normal equations: (..., m, k), (..., m) -> (..., k)."""
    At = A.transpose(-1, -2)
    AtA = At @ A + 1e-9 * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(AtA, (At @ b[..., None]))[0][..., 0]


def _sign_nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(torch.where(x == 0, torch.ones_like(x), x))


def _betas_approx_1(L, rho):
    x = _lstsq(L[..., [0, 1, 3, 6]], rho)  # [b1^2, b1b2, b1b3, b1b4]
    b1 = torch.sqrt(torch.clamp(torch.abs(x[..., 0]), min=1e-12))
    sgn = _sign_nonzero(x[..., 0])
    return torch.stack([b1, sgn * x[..., 1] / b1, sgn * x[..., 2] / b1, sgn * x[..., 3] / b1], dim=-1)


def _b1_b2(x):
    b1 = torch.sqrt(torch.clamp(torch.abs(x[..., 0]), min=1e-12))
    b2 = torch.sqrt(torch.clamp(torch.abs(x[..., 2]), min=1e-12)) * torch.sign(x[..., 1]) * torch.sign(x[..., 0])
    return b1, b2


def _betas_approx_2(L, rho):
    b1, b2 = _b1_b2(_lstsq(L[..., [0, 1, 2]], rho))  # [b1^2, b1b2, b2^2]
    z = torch.zeros_like(b1)
    return torch.stack([b1, b2, z, z], dim=-1)


def _betas_approx_3(L, rho):
    x = _lstsq(L[..., [0, 1, 2, 3, 4]], rho)  # [b1^2, b1b2, b2^2, b1b3, b2b3]
    b1, b2 = _b1_b2(x)
    return torch.stack([b1, b2, x[..., 3] / b1, torch.zeros_like(b1)], dim=-1)


def _gauss_newton(L, rho, b):
    """Refine betas minimising |L f(beta) - rho|^2."""
    for _ in range(GN_ITERATIONS):
        b1, b2, b3, b4 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        z = torch.zeros_like(b1)
        prod = torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4], -1)
        jac = torch.stack(  # d products / d beta: (..., 10, 4)
            [
                torch.stack([2 * b1, z, z, z], -1), torch.stack([b2, b1, z, z], -1),
                torch.stack([z, 2 * b2, z, z], -1), torch.stack([b3, z, b1, z], -1),
                torch.stack([z, b3, b2, z], -1), torch.stack([z, z, 2 * b3, z], -1),
                torch.stack([b4, z, z, b1], -1), torch.stack([z, b4, z, b2], -1),
                torch.stack([z, z, b4, b3], -1), torch.stack([z, z, z, 2 * b4], -1),
            ],
            dim=-2,
        )
        r = rho - (L @ prod[..., None])[..., 0]
        b = b + _lstsq(L @ jac, r)
    return b


def _pose_from_betas(V, betas, alphas, pw, w):
    """Camera-frame control points from the betas -> camera-frame points
    (depth sign fixed positive) -> rigid Horn alignment -> (R, t)."""
    ccs = torch.sum(betas[..., :, None] * V, dim=-2).reshape(V.shape[:-2] + (4, 3))
    pc = alphas @ ccs
    depth = torch.sum(pc[..., 2] * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    pc = pc * _sign_nonzero(depth)[..., None, None]
    _, R, t = horn_sim3(pw, pc, w=w, with_scale=False)
    return R, t


def _reproj_err(R, t, pw, uv, K, w):
    """Weighted mean squared reprojection error; points behind count 1e12."""
    pc = pw @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(pc[..., 2], min=1e-12)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    e = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    e = torch.where(pc[..., 2] <= 0, torch.full_like(e, 1e12), e)
    return torch.sum(e * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1e-12)


def epnp(pw: torch.Tensor, uv: torch.Tensor, K: torch.Tensor, w: torch.Tensor | None = None):
    """EPnP pose from 3D-2D correspondences.

    Args: pw (..., N, 3) world points; uv (..., N, 2) pixels; K (3, 3); w
      optional (..., N) weights or mask (>= 4 effective points). Leading dims
      broadcast: pw (N, 3) with w (B, N) solves B hypotheses.

    Returns (R (..., 3, 3), t (..., 3), mean squared reprojection error
    over the weighted points (...,)).
    """
    if w is None:
        w = torch.ones(pw.shape[:-1], dtype=pw.dtype, device=pw.device)
    w = w.to(pw.dtype)
    cw = _control_points(pw, w)
    alphas = _barycentric(pw, cw)
    M = _build_M(alphas, uv, K, w)
    _, vecs = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    V = vecs[..., :, :4].transpose(-1, -2)  # the 4 smallest eigenvectors, as rows
    L, rho = _L_and_rho(V, cw)

    batch = torch.broadcast_shapes(pw.shape[:-2], w.shape[:-1])
    best_R = torch.eye(3, dtype=pw.dtype, device=pw.device).expand(batch + (3, 3))
    best_t = torch.zeros(batch + (3,), dtype=pw.dtype, device=pw.device)
    best_e = torch.full(batch, float("inf"), dtype=pw.dtype, device=pw.device)
    for init in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
        R, t = _pose_from_betas(V, _gauss_newton(L, rho, init(L, rho)), alphas, pw, w)
        e = _reproj_err(R, t, pw, uv, K, w)
        take = e < best_e
        best_R = torch.where(take[..., None, None], R, best_R)
        best_t = torch.where(take[..., None], t, best_t)
        best_e = torch.where(take, e, best_e)
    return best_R, best_t, best_e
