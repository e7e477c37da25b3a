"""ORB keypoint selection, orientation and rotated-BRIEF descriptors.

Port of ``orbslam_in_practice_tpu/ops/orb.py``. ``ic_angle``,
``gaussian_blur7`` (``ops/image.py``) and ``brief_descriptors`` together are
the plain version of kernel B (``ops/cuda_patch.py``).

``lax.top_k`` breaks ties toward the lower index and ``torch.topk`` does not
promise any order, so every top-k here is a stable descending sort.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from orbslam_in_practice_tpu_torch.ops.hamming import pack_bits
from orbslam_in_practice_tpu_torch.ops.orb_pattern import ORB_PATTERN

PATCH_R = 15  # IC-angle patch radius (31x31)
DESC_R = 19  # descriptor gather radius (rotated pattern reach)
BORDER = 19  # keypoint exclusion border

_DY31, _DX31 = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1].astype(np.float32)
_CIRCLE31 = (_DX31 * _DX31 + _DY31 * _DY31 <= PATCH_R * PATCH_R).astype(np.float32)


def orb_pattern(device: torch.device | str = "cpu") -> torch.Tensor:
    """(256, 2, 2) float32 BRIEF pattern: [pair, point (a|b), (x, y)]."""
    return torch.as_tensor(ORB_PATTERN, dtype=torch.float32, device=device)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties by lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(
    score: torch.Tensor,
    budget: int,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    cell: int = 32,
    border: int = BORDER,
):
    """Grid-uniform top-k keypoint selection from an NMS'd score map.

    Every 32x32 cell contributes its best keypoint before any cell
    contributes its second; low-threshold corners are eligible only in cells
    with no high-threshold corner.

    Returns (yx (budget, 2) int32, response (budget,) f32, valid (budget,)).
    """
    h, w = score.shape
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    interior = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    score = torch.where(interior, score, torch.zeros_like(score))

    hp = (h + cell - 1) // cell * cell
    wp = (w + cell - 1) // cell * cell
    sp = F.pad(score, (0, wp - w, 0, hp - h))
    hc, wc = hp // cell, wp // cell
    cells = sp.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)

    cell_max = torch.amax(cells, dim=-1, keepdim=True)
    has_ini = cell_max > ini_th
    zero = torch.zeros_like(cells)
    eligible = torch.where(
        cells > ini_th, cells, torch.where((cells > min_th) & ~has_ini, cells, zero)
    )

    n_cells = hc * wc
    m = max(1, min(cell * cell, -(-2 * budget // n_cells) + 2))
    vals, idx_in_cell = _top_k(eligible, m)  # (n_cells, m)

    # round-robin by in-cell rank: all rank-0 first (by score), then rank-1...
    rank = torch.arange(m, device=score.device, dtype=torch.float32).expand(vals.shape)
    key = torch.where(vals > 0.0, rank * 1e6 - vals, torch.full_like(vals, float("inf")))
    neg = -key.reshape(-1)
    neg = torch.where(torch.isfinite(neg), neg, torch.full_like(neg, -float("inf")))
    take_vals, take_idx = _top_k(neg, budget)
    valid = torch.isfinite(take_vals)

    cell_id = take_idx // m
    kth = take_idx % m
    in_cell = idx_in_cell[cell_id, kth]
    y = (cell_id // wc) * cell + in_cell // cell
    x = (cell_id % wc) * cell + in_cell % cell
    response = vals[cell_id, kth]
    valid = valid & (response > 0.0) & (y < h) & (x < w)
    yx = torch.stack([y, x], dim=-1).to(torch.int32)
    yx = torch.where(valid[:, None], yx, torch.zeros_like(yx))
    return yx, torch.where(valid, response, torch.zeros_like(response)), valid


def _gather_patches(img: torch.Tensor, yx: torch.Tensor, radius: int) -> torch.Tensor:
    """(H, W), (N, 2) int -> (N, 2r+1, 2r+1) patches; the window is shifted
    to stay inside the image."""
    size = 2 * radius + 1
    h, w = img.shape
    off = torch.arange(size, device=img.device)
    y0 = torch.clamp(yx[:, 0].long() - radius, 0, h - size)
    x0 = torch.clamp(yx[:, 1].long() - radius, 0, w - size)
    rows = (y0[:, None] + off)[:, :, None]
    cols = (x0[:, None] + off)[:, None, :]
    return img[rows, cols]


def ic_angle(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (radians) per keypoint."""
    patches = _gather_patches(img, yx, PATCH_R)  # (N, 31, 31)
    wx = torch.as_tensor(_DX31 * _CIRCLE31, device=img.device)
    wy = torch.as_tensor(_DY31 * _CIRCLE31, device=img.device)
    m10 = torch.sum(patches * wx, dim=(-1, -2))
    m01 = torch.sum(patches * wy, dim=(-1, -2))
    return torch.atan2(m01, m10)


def brief_descriptors(
    img_blur: torch.Tensor,
    yx: torch.Tensor,
    angle: torch.Tensor,
    pattern: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotated-BRIEF 256-bit descriptors, packed (N, 8) int32.

    Pattern points are rotated by the keypoint angle, rounded half to even
    and clipped to the 19 px reach, then compared pairwise:
    bit k = I(p_a) < I(p_b).
    """
    if pattern is None:
        pattern = orb_pattern(img_blur.device)
    size = 2 * DESC_R + 1
    n = yx.shape[0]
    flat = _gather_patches(img_blur, yx, DESC_R).reshape(n, size * size)
    ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    px, py = pattern[None, :, :, 0], pattern[None, :, :, 1]  # (1, 256, 2)
    rx = torch.round(px * ca - py * sa).to(torch.int64).clamp(-DESC_R, DESC_R)
    ry = torch.round(px * sa + py * ca).to(torch.int64).clamp(-DESC_R, DESC_R)
    idx = (ry + DESC_R) * size + (rx + DESC_R)  # (N, 256, 2)
    vals = torch.gather(flat, 1, idx.reshape(n, 512)).reshape(n, 256, 2)
    return pack_bits((vals[..., 0] < vals[..., 1]).to(torch.uint8))


def level_budgets(n_features: int, n_levels: int, scale: float) -> list:
    """Per-level feature budgets proportional to (1/scale)^level."""
    inv = 1.0 / scale
    factors = np.array([inv**i for i in range(n_levels)])
    raw = n_features * factors / factors.sum()
    budgets = [int(round(x)) for x in raw]
    budgets[-1] = max(1, n_features - sum(budgets[:-1]))
    return budgets
