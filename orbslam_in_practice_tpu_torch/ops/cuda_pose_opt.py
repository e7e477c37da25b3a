"""Pose-only bundle adjustment in one launch (``csrc/pose_opt.cu``).

``pose_optimization_launch`` runs the whole of
``optim/pose_opt.py::pose_optimization`` (4 rounds of at most 10 LM steps,
the re-gating after each) as one block on the card. It replaces no Pallas
kernel: the JAX package left this function to XLA. Its plain version is
``optim/pose_opt.py::pose_optimization_plain``, which
``pose_optimization`` runs for CPU tensors; for CUDA tensors it launches
this kernel or raises.
"""

from __future__ import annotations

import torch

from orbslam_in_practice_tpu_torch.ops.cuda_build import check_cuda_tensor, check_launch, library


def pose_optimization_launch(Tcw0, Xw, uv, inv_sigma2, valid, K):
    """One launch of the kernel on the current stream. Inputs as
    ``pose_optimization``'s, contiguous CUDA tensors on one device: Tcw0
    (4, 4), Xw (N, 3), uv (N, 2), inv_sigma2 (N,) and K (3, 3) float32,
    valid (N,) bool.

    Returns (Tcw (4, 4) float32, inlier (N,) bool, the number of inliers
    and the number of LM steps accepted, each an int64 scalar), all on the
    device: the caller reads nothing back."""
    check_cuda_tensor(Xw, "Xw", torch.float32, (None, 3))
    n = Xw.shape[0]
    for name, t, dtype, shape in (
        ("Tcw0", Tcw0, torch.float32, (4, 4)), ("Xw", Xw, torch.float32, (n, 3)),
        ("uv", uv, torch.float32, (n, 2)), ("inv_sigma2", inv_sigma2, torch.float32, (n,)),
        ("valid", valid, torch.bool, (n,)), ("K", K, torch.float32, (3, 3)),
    ):
        check_cuda_tensor(t, name, dtype, shape)
        if t.device != Tcw0.device:
            raise ValueError(f"{name}: expected device {Tcw0.device}, got {t.device}")
    device = Tcw0.device
    Tcw = torch.empty((4, 4), dtype=torch.float32, device=device)
    inlier = torch.empty((n,), dtype=torch.bool, device=device)
    counts = torch.empty((2,), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = library().pose_optimization_launch(
            Tcw0.data_ptr(), Xw.data_ptr(), uv.data_ptr(), inv_sigma2.data_ptr(), valid.data_ptr(), K.data_ptr(),
            n, Tcw.data_ptr(), inlier.data_ptr(), counts.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch("pose_optimization_launch", err)
    return Tcw, inlier, counts[0], counts[1]
