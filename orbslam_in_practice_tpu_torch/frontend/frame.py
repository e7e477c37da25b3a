"""Frame: fixed-shape per-image feature container.

Port of ``orbslam_in_practice_tpu/frontend/frame.py``: a NamedTuple of
tensors with a leading dim of n_features (fixed budget, validity-masked).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Frame(NamedTuple):
    xy: torch.Tensor  # (N, 2) float32 undistorted level-0 pixel coords
    xy_raw: torch.Tensor  # (N, 2) float32 raw (distorted) pixel coords
    octave: torch.Tensor  # (N,) int32 pyramid level
    angle: torch.Tensor  # (N,) float32 orientation (radians)
    response: torch.Tensor  # (N,) float32 FAST score
    valid: torch.Tensor  # (N,) bool
    desc_packed: torch.Tensor  # (N, 8) int32 BRIEF bits (uint32 words' bits)
    desc_pm1: torch.Tensor  # (N, 256) int8 ±1 (matmul-ready)

    @property
    def n_features(self) -> int:
        return self.xy.shape[0]

    def num_valid(self) -> torch.Tensor:
        """The number of valid features, a 0-dim tensor on the frame's device."""
        return torch.sum(self.valid)
