"""DLT triangulation, batched.

Port of ``orbslam_in_practice_tpu/geometry/triangulate.py``: the 4x4 DLT
system, row-normalised, solved as the eigenvector of the smallest eigenvalue
of A^T A (its sign cancels in the dehomogenisation).
"""

from __future__ import annotations

import torch


def triangulate_dlt(
    P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Triangulate points from two views.

    P1, P2: (..., 3, 4) projection matrices K [R|t]; x1, x2: (..., 2) pixel
    observations. Returns (..., 3) world points.
    """
    rows = [
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)  # (..., 4, 4)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]
