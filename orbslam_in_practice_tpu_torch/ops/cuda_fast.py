"""Kernel A: fused FAST-9/16 score + 3x3 NMS (``csrc/fast_score_nms.cu``).

Port of the Pallas kernel ``orbslam_in_practice_tpu/ops/pallas_fast.py``.
``fast_score_nms_levels`` launches the CUDA kernel once over every pyramid
level for CUDA tensors and runs the plain version,
``fast_score_nms_levels_plain``, for CPU tensors; there is no fallback from
one to the other. The two agree bit for bit. ``fast_score_nms`` is the
one-level case of the same kernel.
"""

from __future__ import annotations

import ctypes

import torch

from orbslam_in_practice_tpu_torch.ops.cuda_build import check_cuda_tensor, check_launch, host_array, library
from orbslam_in_practice_tpu_torch.ops.fast import fast_score, nms3x3

MAX_LEVELS = 8  # the kernel's by-value level table (csrc/fast_score_nms.cu)


def fast_score_nms_plain(img: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``nms3x3(fast_score(img))``."""
    return nms3x3(fast_score(img))


def fast_score_nms_levels_plain(levels: list) -> list:
    """The plain version, level by level."""
    return [fast_score_nms_plain(img) for img in levels]


def _launch(levels: list) -> list:
    """One launch of the kernel over ``levels`` (CUDA tensors); the
    outputs are views of one flat buffer."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_score_nms_levels takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    device = levels[0].device
    for i, img in enumerate(levels):
        check_cuda_tensor(img, f"levels[{i}]", torch.float32, (None, None))
        if img.device != device:
            raise ValueError("every level must be on one device")
    sizes = [img.numel() for img in levels]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    outs = [o.view(img.shape) for o, img in zip(flat.split(sizes), levels)]
    with torch.cuda.device(device):
        err = library().fast_score_nms_levels(
            host_array(ctypes.c_void_p, (img.data_ptr() for img in levels)),
            host_array(ctypes.c_void_p, (o.data_ptr() for o in outs)),
            host_array(ctypes.c_int, (d for img in levels for d in img.shape)),
            len(levels),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch("fast_score_nms_levels", err)
    return outs


def fast_score_nms_levels(levels: list) -> list:
    """NMS'd FAST score maps of every pyramid level in one launch.

    levels: up to ``MAX_LEVELS`` (H_l, W_l) float32 images. Returns one
    (H_l, W_l) float32 map per level, with the 3 px border zero; on the card
    they are contiguous views of one buffer. ``fast_score_nms.launches``
    counts kernel launches.
    """
    if all(img.device.type == "cpu" for img in levels):
        return fast_score_nms_levels_plain(levels)
    outs = _launch(levels)
    fast_score_nms.launches += 1
    return outs


def fast_score_nms(img: torch.Tensor) -> torch.Tensor:
    """NMS'd FAST score map of one image: the one-level case.
    img: (H, W) float32 -> (H, W) float32, with the 3 px border zero."""
    return fast_score_nms_levels([img])[0]


fast_score_nms.launches = 0
