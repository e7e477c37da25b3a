"""Sim(3) exponential and logarithm for the essential-graph optimisation.

Port of ``orbslam_in_practice_tpu/geometry/sim3_lie.py``: a Sim3 element is
the matrix G = [[s R, t], [0, 1]], its tangent xi = [rho (3), phi (3),
sigma (1)] with s = exp(sigma). The W matrix couples rho to t; its
small-angle and small-sigma branches are both computed and one picked by
``torch.where``, so the functions stay differentiable in forward mode
(``torch.func.jacfwd``): the tangent of the branch not taken is dropped by
the ``where``, NaN or not. All functions broadcast over leading dims.
"""

from __future__ import annotations

import torch

from orbslam_in_practice_tpu_torch.geometry.se3 import exp_so3, hat, log_so3

_EPS = 1e-6


def _calc_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W(phi, sigma) = int_0^1 e^(sigma u) e^(hat(phi) u) du, (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    s = torch.exp(sigma)
    Om = hat(phi)
    Om2 = Om @ Om
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Om.shape)

    small_sigma = torch.abs(sigma) < _EPS
    small_theta = theta < _EPS

    # sigma ~ 0
    C_s0 = torch.ones_like(sigma)
    A_s0 = torch.where(small_theta, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    B_s0 = torch.where(small_theta, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))

    # sigma != 0 (the unused lane divides by 1, not 0)
    sig = torch.where(small_sigma, torch.ones_like(sigma), sigma)
    C_s = (s - 1.0) / sig
    sig2 = sig * sig
    A_th0 = ((sig - 1.0) * s + 1.0) / sig2
    B_th0 = (s * 0.5 * sig2 + s - 1.0 - sig * s) / (sig2 * sig)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sig2
    th_safe = torch.where(small_theta, torch.ones_like(theta), theta)
    A_th = (a * sig + (1.0 - b) * th_safe) / (th_safe * c)
    B_th = (C_s - ((b - 1.0) * sig + a * th_safe) / c) / torch.clamp(theta2, min=1e-24)
    A_s = torch.where(small_theta, A_th0, A_th)
    B_s = torch.where(small_theta, B_th0, B_th)

    A = torch.where(small_sigma, A_s0, A_s)
    B = torch.where(small_sigma, B_s0, B_s)
    C = torch.where(small_sigma, C_s0, C_s)
    return C[..., None, None] * eye + A[..., None, None] * Om + B[..., None, None] * Om2


def _from_blocks(sR: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4) [[sR, t], [0, 1]]."""
    top = torch.cat([sR, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=sR.dtype, device=sR.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def exp_sim3(xi: torch.Tensor) -> torch.Tensor:
    """(..., 7) tangent [rho, phi, sigma] -> (..., 4, 4) Sim3 matrix."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    t = (_calc_W(phi, sigma) @ rho[..., None])[..., 0]
    return _from_blocks(s[..., None, None] * exp_so3(phi), t)


def _scale(G: torch.Tensor) -> torch.Tensor:
    """s of [[sR, t], [0, 1]] from the Frobenius norm |sR| = s sqrt(3)."""
    sR = G[..., :3, :3]
    return torch.sqrt(torch.clamp(torch.sum(sR * sR, dim=(-1, -2)) / 3.0, min=1e-24))


def log_sim3(G: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) Sim3 -> (..., 7) tangent [rho, phi, sigma]."""
    s = _scale(G)
    sigma = torch.log(s)
    phi = log_so3(G[..., :3, :3] / s[..., None, None])
    rho = torch.linalg.solve(_calc_W(phi, sigma), G[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_inverse(G: torch.Tensor) -> torch.Tensor:
    """[[sR, t], [0, 1]]^-1 = [[R^T / s, -R^T t / s], [0, 1]]."""
    sR = G[..., :3, :3]
    s2 = torch.clamp(torch.sum(sR * sR, dim=(-1, -2)) / 3.0, min=1e-24)
    inv_sR = sR.transpose(-1, -2) / s2[..., None, None]
    return _from_blocks(inv_sR, -(inv_sR @ G[..., :3, 3:4])[..., 0])


def se3_to_sim3(T: torch.Tensor, s: torch.Tensor | float = 1.0) -> torch.Tensor:
    """SE3 matrix and scale -> Sim3 matrix."""
    s = torch.as_tensor(s, dtype=T.dtype, device=T.device)
    out = T.clone()
    out[..., :3, :3] = T[..., :3, :3] * (s[..., None, None] if s.dim() else s)
    return out


def sim3_to_se3(G: torch.Tensor):
    """Sim3 -> (SE3 matrix with the unit-scale rotation, scale)."""
    s = _scale(G)
    T = G.clone()
    T[..., :3, :3] = G[..., :3, :3] / s[..., None, None]
    return T, s
