"""DLT triangulation, batched.

Port of ``orbslam_in_practice_tpu/geometry/triangulate.py``: the 4x4 DLT
system, row-normalised, solved as the eigenvector of the smallest eigenvalue
of A^T A (its sign cancels in the dehomogenisation).

The eigensolver takes the systems at most ``EIGH_BATCH_MAX`` at a time: on
the card (torch 2.11, CUDA 12.8, H100) cuSOLVER's batched solver refused a
batch of 32,000 4x4 systems (``CUSOLVER_STATUS_INVALID_VALUE``: the KITTI
turn's initialisation, 8 hypotheses x 4000 matches) and solved 16,000.
A batch up to that size is one call, as before; each system is solved on
its own, so a larger batch's split changes no result.
"""

from __future__ import annotations

import torch

EIGH_BATCH_MAX = 16000  # the largest batch of systems seen solved on the card


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
    AtA = A.transpose(-1, -2) @ A
    vecs = torch.cat([torch.linalg.eigh(m)[1] for m in AtA.reshape(-1, 4, 4).split(EIGH_BATCH_MAX)])
    X = vecs.reshape(AtA.shape)[..., :, 0]  # eigenvector of the smallest eigenvalue
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]
