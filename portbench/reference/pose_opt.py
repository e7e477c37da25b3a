"""Pose-only bundle adjustment of the plain reference: a frozen copy of the
port's ``optim/pose_opt.py`` (Huber kernel, 4 rounds of 10 masked
Levenberg-Marquardt steps with chi2 re-gating), plain torch, in whatever
float type its inputs hold.
"""

from __future__ import annotations

import torch

from portbench.reference.se3 import exp_se3, hat

CHI2_MONO = 5.991
HUBER_DELTA = CHI2_MONO**0.5
ROUNDS = 4
ITERS_PER_ROUND = 10


def _residual_jacobian(Tcw, Xw, uv, K):
    """Residuals r = uv - proj (N, 2), Jacobians w.r.t. a left perturbation
    of Tcw with tangent [rho, phi] (N, 2, 6), and camera-frame depth (N,)."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = Xw @ R.T + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = fx * x / z_safe + cx
    v = fy * y / z_safe + cy
    r = uv - torch.stack([u, v], dim=-1)

    zi = 1.0 / z_safe
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    J_proj = torch.stack(
        [
            torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1),
            torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    eye = torch.eye(3, dtype=Tcw.dtype, device=Tcw.device).expand(pc.shape[:-1] + (3, 3))
    dpc = torch.cat([eye, -hat(pc)], dim=-1)  # (N, 3, 6): pc' = pc + rho + phi x pc
    return r, -J_proj @ dpc, z


def _chi2(r, inv_sigma2):
    return torch.sum(r * r, dim=-1) * inv_sigma2


def _rho(chi2, use_huber: bool):
    if not use_huber:
        return chi2
    d2 = HUBER_DELTA * HUBER_DELTA
    return torch.where(chi2 <= d2, chi2, 2.0 * HUBER_DELTA * torch.sqrt(chi2) - d2)


def _lm_round(Tcw, Xw, uv, inv_sigma2, inlier, K, use_huber: bool):
    dtype, device = Tcw.dtype, Tcw.device
    w_mask = inlier.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=device)
    lam = torch.tensor(1e-3, dtype=dtype, device=device)
    done = torch.tensor(False, device=device)
    for _ in range(ITERS_PER_ROUND):
        r, J, _ = _residual_jacobian(Tcw, Xw, uv, K)
        chi2 = _chi2(r, inv_sigma2)
        if use_huber:
            # IRLS Huber weight: min(1, delta / |r|_Sigma)
            wh = torch.clamp(HUBER_DELTA / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)
        else:
            wh = torch.ones_like(chi2)
        sw = torch.sqrt(w_mask * inv_sigma2 * wh)[:, None]
        A = (J * sw[..., None]).reshape(-1, 6)
        b = (r * sw).reshape(-1)
        H = A.T @ A
        g = -(b @ A)
        H_damped = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
        delta = torch.linalg.solve_ex(H_damped, g)[0]
        Tcw_new = exp_se3(delta) @ Tcw
        r_new, _, _ = _residual_jacobian(Tcw_new, Xw, uv, K)
        err_new = torch.sum(_rho(_chi2(r_new, inv_sigma2), use_huber) * w_mask)
        err_old = torch.sum(_rho(chi2, use_huber) * w_mask)
        accept = err_new < err_old
        active = ~done
        Tcw = torch.where(active & accept, Tcw_new, Tcw)
        lam = torch.where(active, torch.where(accept, lam * 0.5, lam * 4.0), lam)
        # converged: the step's update vanished
        done = done | (torch.sum(delta * delta) < 1e-12)
    return Tcw


def pose_optimization(
    Tcw0: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
):
    """Optimise one camera pose against fixed 3D points.

    Args: Tcw0 (4, 4) initial world->camera pose; Xw (N, 3) fixed points;
      uv (N, 2) undistorted pixel observations; inv_sigma2 (N,) information
      per observation; valid (N,) bool; K (3, 3).

    Returns (Tcw, inlier mask (N,), number of inliers).
    """
    inlier = valid
    Tcw = Tcw0
    for rnd in range(ROUNDS):
        Tcw = _lm_round(Tcw, Xw, uv, inv_sigma2, inlier, K, rnd < ROUNDS - 1)
        r, _, z = _residual_jacobian(Tcw, Xw, uv, K)
        inlier = valid & (_chi2(r, inv_sigma2) <= CHI2_MONO) & (z > 0)
    return Tcw, inlier, torch.sum(inlier)
