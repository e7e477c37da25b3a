"""Kernel B: per-keypoint angle + in-patch blur + rotated BRIEF
(``csrc/orb_patch.cu``).

Port of the Pallas kernel ``orbslam_in_practice_tpu/ops/pallas_patch.py``.
``orb_patch_features_levels`` launches the CUDA kernel once over the
keypoints of every pyramid level for CUDA tensors and runs the plain
version, ``orb_patch_features_levels_plain``, for CPU tensors; there is no
fallback from one to the other. The kernel takes (cos, sin) as the
normalised moments and the plain version as cos/sin of ``atan2``, so an
angle can differ in the last bits and a rotated sample that rounds near a
half pixel can flip its bit. Both return the descriptor twice: as packed
words and as the ±1 int8 rows the matchers multiply, which the kernel
writes itself. ``orb_patch_features`` is the one-level case.
"""

from __future__ import annotations

import ctypes

import torch

from orbslam_in_practice_tpu_torch.ops.cuda_build import check_cuda_tensor, check_launch, host_array, library
from orbslam_in_practice_tpu_torch.ops.hamming import unpack_to_pm1
from orbslam_in_practice_tpu_torch.ops.image import gaussian_blur7
from orbslam_in_practice_tpu_torch.ops.orb import brief_descriptors, ic_angle

MAX_LEVELS = 8  # the kernel's by-value level table (csrc/orb_patch.cu)


def orb_patch_features_plain(img: torch.Tensor, yx: torch.Tensor, pattern: torch.Tensor):
    """The plain PyTorch version for one level: ``ic_angle`` +
    ``gaussian_blur7`` + ``brief_descriptors`` (whose output is packed)."""
    angle = ic_angle(img, yx)
    return angle, brief_descriptors(gaussian_blur7(img), yx, angle, pattern)


def _level_start(levels: list, yx: torch.Tensor, level_start) -> list:
    start = [int(s) for s in level_start]
    if len(start) != len(levels) + 1 or start[0] != 0 or start[-1] != yx.shape[0]:
        raise ValueError(
            f"level_start must run from 0 to {yx.shape[0]} over {len(levels)} levels, got {start}"
        )
    if any(b < a for a, b in zip(start, start[1:])):
        raise ValueError(f"level_start must not decrease, got {start}")
    return start


def orb_patch_features_levels_plain(levels: list, yx: torch.Tensor, level_start, pattern: torch.Tensor):
    """The plain version, level by level, with ``unpack_to_pm1``."""
    start = _level_start(levels, yx, level_start)
    angs, descs = [], []
    for img, a, b in zip(levels, start, start[1:]):
        ang, desc = orb_patch_features_plain(img, yx[a:b], pattern)
        angs.append(ang)
        descs.append(desc)
    desc = torch.cat(descs)
    return torch.cat(angs), desc, unpack_to_pm1(desc)


def _launch(levels: list, yx: torch.Tensor, level_start, pattern: torch.Tensor):
    """One launch of the kernel over the keypoints of ``levels`` (CUDA
    tensors). No launch when there are no keypoints; returns whether it
    launched, and the outputs."""
    start = _level_start(levels, yx, level_start)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"orb_patch_features_levels takes at most {MAX_LEVELS} levels, got {len(levels)}")
    device = yx.device
    check_cuda_tensor(yx, "yx", torch.int32, (None, 2))
    check_cuda_tensor(pattern, "pattern", torch.float32, (256, 2, 2))
    for i, img in enumerate(levels):
        check_cuda_tensor(img, f"levels[{i}]", torch.float32, (None, None))
    if any(t.device != device for t in (pattern, *levels)):
        raise ValueError("levels, yx and pattern must be on one device")
    n = yx.shape[0]
    angle = torch.empty(n, dtype=torch.float32, device=device)
    desc = torch.empty((n, 8), dtype=torch.int32, device=device)
    pm1 = torch.empty((n, 256), dtype=torch.int8, device=device)
    if n == 0:
        return False, (angle, desc, pm1)
    with torch.cuda.device(device):
        err = library().orb_patch_features_levels(
            host_array(ctypes.c_void_p, (img.data_ptr() for img in levels)),
            host_array(ctypes.c_int, (d for img in levels for d in img.shape)),
            host_array(ctypes.c_int, start),
            len(levels),
            yx.data_ptr(), pattern.data_ptr(), angle.data_ptr(), desc.data_ptr(), pm1.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch("orb_patch_features_levels", err)
    return True, (angle, desc, pm1)


def orb_patch_features_levels(levels: list, yx: torch.Tensor, level_start, pattern: torch.Tensor):
    """Fused angle + blur + BRIEF for the keypoints of every level in one
    launch.

    levels: up to ``MAX_LEVELS`` (H_l, W_l) float32 level images. yx: (N, 2)
    int32 (row, col), the keypoints of level l in rows
    ``level_start[l]:level_start[l + 1]``; padding rows may be (0, 0).
    level_start: len(levels) + 1 ints from 0 to N. pattern: (256, 2, 2)
    float32 BRIEF pattern. Returns (angle (N,) float32 radians, desc (N, 8)
    int32 packed words, pm1 (N, 256) int8 ±1 rows).
    ``orb_patch_features.launches`` counts kernel launches.
    """
    if all(t.device.type == "cpu" for t in (yx, pattern, *levels)):
        return orb_patch_features_levels_plain(levels, yx, level_start, pattern)
    launched, out = _launch(levels, yx, level_start, pattern)
    orb_patch_features.launches += launched
    return out


def orb_patch_features(img: torch.Tensor, yx: torch.Tensor, pattern: torch.Tensor):
    """The one-level case: (angle (N,) float32, desc (N, 8) int32)."""
    return orb_patch_features_levels([img], yx, (0, yx.shape[0]), pattern)[:2]


orb_patch_features.launches = 0
