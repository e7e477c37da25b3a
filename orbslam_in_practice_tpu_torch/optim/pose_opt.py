"""Pose-only bundle adjustment (motion-only BA).

Port of ``orbslam_in_practice_tpu/optim/pose_opt.py``: one SE3 pose, N
monocular reprojection edges, Huber kernel delta = sqrt(5.991), 4 rounds of
at most 10 Levenberg-Marquardt steps; after each round every valid edge is
re-gated at chi2 <= 5.991 (so edges can rejoin), and the last round drops
the robust kernel.

The reference's early-exit while-loop becomes a fixed 10 steps whose
updates are masked once the step has converged: the same result with no
host synchronisation. ``pose_optimization`` runs that torch body,
``pose_optimization_plain``, for CPU tensors; for CUDA tensors it launches
one hand-written kernel for the whole call (``ops/cuda_pose_opt.py``,
``csrc/pose_opt.cu``) or raises. The kernel sums the normal equations and
the errors in float64 and stops a round at convergence, where the plain
version masks the steps left; ``pose_optimization.launches`` counts its
launches. Both return the number of LM steps they accepted.
"""

from __future__ import annotations

import torch

from orbslam_in_practice_tpu_torch.geometry.se3 import exp_se3, hat
from orbslam_in_practice_tpu_torch.ops.cuda_pose_opt import pose_optimization_launch

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
    n_accepted = torch.zeros((), dtype=torch.int64, device=device)
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
        n_accepted = n_accepted + (active & accept)
        Tcw = torch.where(active & accept, Tcw_new, Tcw)
        lam = torch.where(active, torch.where(accept, lam * 0.5, lam * 4.0), lam)
        # converged: the step's update vanished
        done = done | (torch.sum(delta * delta) < 1e-12)
    return Tcw, n_accepted


def pose_optimization_plain(
    Tcw0: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
):
    """The plain PyTorch version of ``pose_optimization``."""
    inlier = valid
    Tcw = Tcw0
    n_accepted = 0
    for rnd in range(ROUNDS):
        Tcw, n_round = _lm_round(Tcw, Xw, uv, inv_sigma2, inlier, K, rnd < ROUNDS - 1)
        n_accepted = n_accepted + n_round
        r, _, z = _residual_jacobian(Tcw, Xw, uv, K)
        inlier = valid & (_chi2(r, inv_sigma2) <= CHI2_MONO) & (z > 0)
    return Tcw, inlier, torch.sum(inlier), n_accepted


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
      per observation; valid (N,) bool; K (3, 3). On the card: contiguous
      float32 (``valid`` bool) tensors on one device.

    Returns (Tcw, inlier mask (N,), number of inliers, number of LM steps
    accepted), the counts as int64 scalars on the inputs' device.
    """
    if Tcw0.device.type == "cpu":
        return pose_optimization_plain(Tcw0, Xw, uv, inv_sigma2, valid, K)
    out = pose_optimization_launch(Tcw0, Xw, uv, inv_sigma2, valid, K)
    pose_optimization.launches += 1
    return out


pose_optimization.launches = 0
