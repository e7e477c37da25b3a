"""ORBExtractor: the multi-scale ORB pipeline as an ``nn.Module``.

Port of ``orbslam_in_practice_tpu/frontend/orb.py``: the pyramid, then
FAST score + 3x3 NMS over every level in one launch (kernel A), grid-uniform
top-k per level, and IC angle + in-patch blur + rotated BRIEF over every
level's keypoints in one launch (kernel B), which also writes the ±1 rows.
Keypoint coordinates are scaled to level 0 and undistorted. All shapes are
static (per-level budgets); levels with a budget of 0 are skipped.

``use_kernels=False`` runs the plain PyTorch versions of both kernels in
place of their wrappers; it exists to time and compare the plain path on
the card. On CPU tensors the wrappers run the plain versions anyway.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from orbslam_in_practice_tpu_torch.frontend.frame import Frame
from orbslam_in_practice_tpu_torch.geometry.camera import CameraIntrinsics, undistort_points
from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms_levels, fast_score_nms_levels_plain
from orbslam_in_practice_tpu_torch.ops.cuda_patch import (
    orb_patch_features_levels,
    orb_patch_features_levels_plain,
)
from orbslam_in_practice_tpu_torch.ops.image import build_pyramid, pyramid_taps
from orbslam_in_practice_tpu_torch.ops.orb import level_budgets, orb_pattern, select_keypoints


class ORBExtractor(nn.Module):
    """Configured like the reference's ORBextractor: (nFeatures,
    scaleFactor, nLevels, iniThFAST, minThFAST)."""

    def __init__(
        self,
        n_features: int = 1000,
        scale_factor: float = 1.2,
        n_levels: int = 8,
        ini_th_fast: float = 20.0,
        min_th_fast: float = 7.0,
        cam: CameraIntrinsics | None = None,
        use_kernels: bool = True,
    ):
        super().__init__()
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = ini_th_fast
        self.min_th = min_th_fast
        self.use_kernels = use_kernels
        self.budgets = level_budgets(n_features, n_levels, scale_factor)
        self.levels = [lvl for lvl, budget in enumerate(self.budgets) if budget > 0]
        kept = [self.budgets[lvl] for lvl in self.levels]
        self.level_start = np.concatenate([[0], np.cumsum(kept)]).tolist()
        octave = np.repeat(np.array(self.levels, np.int32), kept)
        scale = np.repeat(np.array([scale_factor**lvl for lvl in self.levels], np.float32), kept)
        # per-octave information weights 1 / scale^(2 * level) for pose optimisation
        level_sigma2 = np.array([(scale_factor**i) ** 2 for i in range(n_levels)], np.float32)
        self.register_buffer("pattern", orb_pattern())
        self.register_buffer("inv_level_sigma2", torch.from_numpy(1.0 / level_sigma2))
        self.register_buffer("octave", torch.from_numpy(octave))
        self.register_buffer("kp_scale", torch.from_numpy(scale)[:, None])
        self.undistort = cam is not None and cam.has_distortion
        if self.undistort:
            self.register_buffer("K", cam.K())
            self.register_buffer("dist", cam.dist_tensor())
        self._taps = {}  # (H, W, device) -> pyramid_taps

    def _pyramid_taps(self, image: torch.Tensor):
        key = (*image.shape, image.device)
        if key not in self._taps:
            self._taps[key] = pyramid_taps(
                image.shape[0], image.shape[1], self.n_levels, self.scale_factor, image.device
            )
        return self._taps[key]

    def forward(self, image: torch.Tensor) -> Frame:
        """image: (H, W) float32 grayscale in [0, 255] -> Frame."""
        pyramid = build_pyramid(image, self.n_levels, self.scale_factor, self._pyramid_taps(image))
        levels = [pyramid[lvl] for lvl in self.levels]
        if self.use_kernels:
            scores = fast_score_nms_levels(levels)
        else:
            scores = fast_score_nms_levels_plain(levels)
        picks = [
            select_keypoints(score, self.budgets[lvl], self.ini_th, self.min_th)
            for score, lvl in zip(scores, self.levels)
        ]
        yx = torch.cat([p[0] for p in picks])
        if self.use_kernels:
            angle, desc_packed, desc_pm1 = orb_patch_features_levels(levels, yx, self.level_start, self.pattern)
        else:
            angle, desc_packed, desc_pm1 = orb_patch_features_levels_plain(
                levels, yx, self.level_start, self.pattern
            )
        xy_raw = yx.flip(-1).float() * self.kp_scale
        xy = undistort_points(self.K, self.dist, xy_raw) if self.undistort else xy_raw
        return Frame(
            xy=xy,
            xy_raw=xy_raw,
            octave=self.octave.clone(),
            angle=angle,
            response=torch.cat([p[1] for p in picks]),
            valid=torch.cat([p[2] for p in picks]),
            desc_packed=desc_packed,
            desc_pm1=desc_pm1,
        )
