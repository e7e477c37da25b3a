"""Essential-graph (pose-graph) optimisation over Sim(3).

Port of ``orbslam_in_practice_tpu/optim/pose_graph.py``: Gauss-Newton with
Levenberg damping on Sim3 vertices S_iw (world -> keyframe i) against
relative measurements. An edge (i, j) with measurement S_ji has the residual
r_ij = log_sim3(S_ji S_iw S_jw^-1).

Each edge's residual depends on two vertices only, so its Jacobian is two
(7, 7) blocks. The reference takes them as ``jax.vmap`` over edges of
``jax.jacfwd``; here one ``torch.func.jacfwd`` of the batched residuals with
respect to a (7,) perturbation broadcast to every edge gives the same blocks
in 14 forward passes. (Under ``torch.func.vmap`` each edge's scalars become
0-dim tensors, and forward-mode tangents of a 0-dim float32 tensor combined
with a Python float are promoted to float64.) The blocks are laid out as a
dense (7E, 7n) Jacobian, so the Hessian J^T W J and the gradient are matrix
products: their sums run in one fixed order on every run, on the card as on
the CPU. (Scatter-adding the blocks, ``index_put_(accumulate=True)``, sums
with atomics on the card, in another order each run; a loop closure's
result then varied from run to run.) The Hessian is solved as one (7n)^2
system (``torch.linalg.solve_ex``). Each iteration's accept or reject
is a ``torch.where`` on the device, so the loop never waits on the host.
"""

from __future__ import annotations

import torch

from orbslam_in_practice_tpu_torch.geometry.sim3_lie import exp_sim3, log_sim3, sim3_inverse

ITERATIONS = 25  # the loop closer's (the reference's default, 20, has no caller here)


def edge_residual(d_i, d_j, S_i, S_j, S_m):
    """Residual of edges under tangent perturbations of their two vertices:
    (..., 7), (..., 7), (..., 4, 4) x 3 -> (..., 7)."""
    Si = exp_sim3(d_i) @ S_i
    Sj = exp_sim3(d_j) @ S_j
    return log_sim3(S_m @ Si @ sim3_inverse(Sj))


def edge_jacobians(S_i, S_j, S_m):
    """d r_ij / d d_i and d r_ij / d d_j at zero perturbation: (E, 4, 4) x 3
    -> ((E, 7, 7), (E, 7, 7))."""
    zero_e = torch.zeros(S_i.shape[:-2] + (7,), dtype=S_i.dtype, device=S_i.device)

    def residual(d_i, d_j):
        return edge_residual(d_i.expand_as(zero_e), d_j.expand_as(zero_e), S_i, S_j, S_m)

    zero = zero_e.new_zeros(7)
    return torch.func.jacfwd(residual, argnums=(0, 1))(zero, zero)


def optimize_pose_graph(
    S_vertices: torch.Tensor,
    edge_i: torch.Tensor,
    edge_j: torch.Tensor,
    S_meas: torch.Tensor,
    edge_weight: torch.Tensor,
    fixed: torch.Tensor,
) -> torch.Tensor:
    """Optimise Sim3 vertices against relative-pose measurements.

    Args: S_vertices (n, 4, 4) initial world->keyframe Sim3 poses; edge_i,
      edge_j (E,) int vertex indices; S_meas (E, 4, 4) measured S_ji; edge_weight
      (E,) (0 masks an edge); fixed (n,) bool gauge-fixed vertices.

    Returns (n, 4, 4) optimised vertices.
    """
    n = S_vertices.shape[0]
    dtype, device = S_vertices.dtype, S_vertices.device
    ei, ej = edge_i.long(), edge_j.long()
    free = (~fixed).to(dtype)[:, None]
    free_flat = free[:, 0].repeat_interleave(7)
    w = edge_weight.to(dtype)
    w7 = w.repeat_interleave(7)
    zero_e = torch.zeros((ei.shape[0], 7), dtype=dtype, device=device)
    eye = torch.eye(n * 7, dtype=dtype, device=device)
    vertices = torch.arange(n, device=device)
    Pi = (ei[:, None] == vertices).to(dtype)  # (E, n) one-hot
    Pj = (ej[:, None] == vertices).to(dtype)
    S, lam = S_vertices, torch.tensor(1e-6, dtype=dtype, device=device)
    for _ in range(ITERATIONS):
        Si, Sj = S[ei], S[ej]
        r0 = edge_residual(zero_e, zero_e, Si, Sj, S_meas)  # (E, 7)
        Ji, Jj = edge_jacobians(Si, Sj, S_meas)
        J = (torch.einsum("eab,en->eanb", Ji, Pi) + torch.einsum("eab,en->eanb", Jj, Pj)).reshape(-1, n * 7)
        Jw = J * w7[:, None]
        H = Jw.T @ J
        g = -(Jw.T @ r0.reshape(-1)) * free_flat
        # gauge: fixed vertices' rows and columns zeroed, identity diagonal
        H = H * free_flat[:, None] * free_flat[None, :] + torch.diag(1.0 - free_flat)
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye
        delta = torch.linalg.solve_ex(H, g)[0].reshape(n, 7) * free
        S_new = exp_sim3(delta) @ S
        cost_old = torch.sum(r0.reshape(-1) ** 2 * w7)
        r_new = edge_residual(zero_e, zero_e, S_new[ei], S_new[ej], S_meas)
        cost_new = torch.sum(r_new.reshape(-1) ** 2 * w7)
        ok = torch.isfinite(cost_new) & (cost_new < cost_old)
        S = torch.where(ok, S_new, S)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    return S
