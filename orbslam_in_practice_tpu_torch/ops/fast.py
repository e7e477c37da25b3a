"""FAST-9/16 corner scoring + 3x3 NMS: the plain versions of kernel A.

Port of ``orbslam_in_practice_tpu/ops/fast.py``. The 16-pixel Bresenham
circle is 16 rolled copies of the image; the FAST score (the highest
threshold at which the pixel is still a corner) is, per polarity, the max
over the 16 circular windows of the min margin over 9 contiguous circle
pixels. A pixel is a corner at threshold t iff score > t. 3x3 non-max
suppression keeps pixels whose score is >= the 3x3 max.

Every operation is a subtraction, min or max in float32, so the CUDA
kernel (``ops/cuda_fast.py``) reproduces these values bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# OpenCV FAST-16 circle offsets (x, y), circular order, radius 3.
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)

_ARC = 9  # contiguous arc length for FAST-9


def _interior(h: int, w: int, margin: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 corner score map. img (H, W) float32 -> (H, W) float32.

    A 3px border is zeroed (the circle would wrap).
    """
    h, w = img.shape
    neigh = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for (dx, dy) in _CIRCLE]
    )  # (16, H, W)
    m = neigh - img[None]  # margin for the brighter arc; the darker one is -m

    # circular window-min of length 9 via a doubling tree:
    # min9(k) = min(min8(k), m(k+8)); the darker polarity's window-min is
    # -window-max of the same margins
    def win9(x, op):
        x2 = op(x, torch.roll(x, -1, dims=0))
        x4 = op(x2, torch.roll(x2, -2, dims=0))
        x8 = op(x4, torch.roll(x4, -4, dims=0))
        return op(x8, torch.roll(x, -8, dims=0))

    bright = torch.amax(win9(m, torch.minimum), dim=0)
    dark = -torch.amin(win9(m, torch.maximum), dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    return torch.where(_interior(h, w, 3, img.device), score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep pixels whose score is >= the max of their 3x3 neighbourhood
    (outside the image counts as -inf)."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= pooled, score, torch.zeros_like(score))


def fast_corners_np(img: np.ndarray, threshold: float) -> np.ndarray:
    """The slow numpy golden model of FAST-9: (H, W) bool, a pixel of the 3 px
    interior is a corner when 9 contiguous circle pixels all differ from it
    by more than ``threshold``, all brighter or all darker."""
    h, w = img.shape
    out = np.zeros((h, w), dtype=bool)
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            c = img[y, x]
            vals = np.array([img[y + dy, x + dx] for (dx, dy) in _CIRCLE])
            for margin in (vals - c, c - vals):
                run, best = 0, 0
                for v in np.concatenate([margin > threshold] * 2):
                    run = run + 1 if v else 0
                    best = max(best, run)
                if best >= _ARC:
                    out[y, x] = True
    return out
