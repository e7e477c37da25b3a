"""The ORB extractor of the plain reference: a frozen copy of the port's
plain path (``ops/image.py``'s pyramid and blur, ``ops/fast.py``'s FAST
score and NMS, ``ops/orb.py``'s grid top-k, intensity-centroid angle and
rotated BRIEF), which the port's two CUDA kernels (FAST+NMS; angle, blur
and BRIEF) reproduce, and ``extract``, which runs it as ``ORBExtractor``
does. Plain torch, float32; ``control=True`` rounds the pyramid and the
blurred levels to bfloat16, the lower precision of the control.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.pattern import ORB_PATTERN


@lru_cache(maxsize=None)
def _gauss_kernel7(sigma: float = 2.0) -> np.ndarray:
    x = np.arange(7, dtype=np.float64) - 3.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """7x7 separable Gaussian with replicated borders. img: (H, W) float32.

    Statically shifted weighted adds (rows first, then columns) in exact
    float32, summed in the reference's order; not a convolution.
    """
    k = [float(v) for v in _gauss_kernel7(sigma)]
    h, w = img.shape
    x = F.pad(img[None, None], (0, 0, 3, 3), mode="replicate")[0, 0]
    y = k[0] * x[0:h, :]
    for i in range(1, 7):
        y = y + k[i] * x[i : i + h, :]
    y = F.pad(y[None, None], (3, 3, 0, 0), mode="replicate")[0, 0]
    out = k[0] * y[:, 0:w]
    for j in range(1, 7):
        out = out + k[j] * y[:, j : j + w]
    return out


def build_pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static (h, w) per level, floor-scaled like the reference."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale**lvl)
        shapes.append((max(int(round(height * inv)), 32), max(int(round(width * inv)), 32)))
    return shapes


def resize_taps(n_in: int, n_out: int):
    """The two taps of one axis of ``jax.image.resize(..., "bilinear",
    antialias=False)`` as the compiled reference computes them.

    Returns numpy (i0, i1, w0, w1): output k = w0[k] * x[i0[k]] +
    w1[k] * x[i1[k]]. The reference's sample position is one fused
    multiply-add, (k + 0.5) * inv_scale - 0.5 rounded once; the triangle
    weights are normalised per output as it normalises them. Downscaling
    without antialiasing gives at most two adjacent nonzero taps.
    """
    inv_scale = np.float32(1.0 / (n_out / n_in))
    sample = ((np.arange(n_out) + 0.5) * np.float64(inv_scale) - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    wts = np.maximum(np.float32(1.0) - x, np.float32(0.0))
    total = wts.sum(axis=0, keepdims=True, dtype=np.float32)
    ok = np.abs(total) > 1000.0 * np.finfo(np.float32).eps
    wts = np.where(ok, wts / np.where(total != 0, total, np.float32(1.0)), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    wts = np.where(inside[None, :], wts, np.float32(0.0))
    cols = np.arange(n_out)
    i0 = np.argmax(wts > 0, axis=0)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w0 = wts[i0, cols]
    w1 = np.where(i1 != i0, wts[i1, cols], np.float32(0.0)).astype(np.float32)
    return i0, i1, w0, w1


def pyramid_taps(height: int, width: int, n_levels: int, scale: float, device="cpu"):
    """Per level >= 1: ((i0, i1, w0, w1) of rows, (...) of columns) tensors."""
    out = []
    for h, w in build_pyramid_shapes(height, width, n_levels, scale)[1:]:
        pair = []
        for n_in, n_out in ((height, h), (width, w)):
            i0, i1, w0, w1 = resize_taps(n_in, n_out)
            pair.append(
                (
                    torch.as_tensor(i0, dtype=torch.int64, device=device),
                    torch.as_tensor(i1, dtype=torch.int64, device=device),
                    torch.as_tensor(w0, device=device),
                    torch.as_tensor(w1, device=device),
                )
            )
        out.append(tuple(pair))
    return out


def _two_tap(x0: torch.Tensor, x1: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor):
    """w0 * x0 + w1 * x1 as a matrix product accumulates it: the first
    product rounded, the second added by one fused multiply-add (emulated in
    float64, where a float32 product is exact)."""
    return (w1.double() * x1.double() + (w0 * x0).double()).float()


def resize_bilinear(img: torch.Tensor, row_taps, col_taps) -> torch.Tensor:
    """Separable 2-tap resize: rows first, then columns."""
    r0, r1, rw0, rw1 = row_taps
    c0, c1, cw0, cw1 = col_taps
    rows = _two_tap(img[r0], img[r1], rw0[:, None], rw1[:, None])
    return _two_tap(rows[:, c0], rows[:, c1], cw0, cw1)


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float, taps=None):
    """Bilinear pyramid; returns a list of (h_l, w_l) float32 tensors.

    ``taps``: ``pyramid_taps`` for this image size on the image's device
    (the extractor owns them); computed here when absent.
    """
    h, w = img.shape
    if taps is None:
        taps = pyramid_taps(h, w, n_levels, scale, img.device)
    return [img] + [resize_bilinear(img, rt, ct) for rt, ct in taps]


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


PATCH_R = 15  # IC-angle patch radius (31x31)
DESC_R = 19  # descriptor gather radius (rotated pattern reach)
BORDER = 19  # keypoint exclusion border

_DY31, _DX31 = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1].astype(np.float32)
_CIRCLE31 = (_DX31 * _DX31 + _DY31 * _DY31 <= PATCH_R * PATCH_R).astype(np.float32)


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
    """Rotated-BRIEF 256-bit descriptors, (N, 256) bool.

    Pattern points are rotated by the keypoint angle, rounded half to even
    and clipped to the 19 px reach, then compared pairwise:
    bit k = I(p_a) < I(p_b).
    """
    size = 2 * DESC_R + 1
    n = yx.shape[0]
    flat = _gather_patches(img_blur, yx, DESC_R).reshape(n, size * size)
    ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    px, py = pattern[None, :, :, 0], pattern[None, :, :, 1]  # (1, 256, 2)
    rx = torch.round(px * ca - py * sa).to(torch.int64).clamp(-DESC_R, DESC_R)
    ry = torch.round(px * sa + py * ca).to(torch.int64).clamp(-DESC_R, DESC_R)
    idx = (ry + DESC_R) * size + (rx + DESC_R)  # (N, 256, 2)
    vals = torch.gather(flat, 1, idx.reshape(n, 512)).reshape(n, 256, 2)
    return vals[..., 0] < vals[..., 1]


def level_budgets(n_features: int, n_levels: int, scale: float) -> list:
    """Per-level feature budgets proportional to (1/scale)^level."""
    inv = 1.0 / scale
    factors = np.array([inv**i for i in range(n_levels)])
    raw = n_features * factors / factors.sum()
    budgets = [int(round(x)) for x in raw]
    budgets[-1] = max(1, n_features - sum(budgets[:-1]))
    return budgets




def undistort_points(K: torch.Tensor, dist, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Radial-tangential undistortion of pixels (..., 2) by ``iters``
    fixed-point iterations, back through K."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xy_d = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    k1, k2, p1, p2, k3 = dist
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xy_d[..., 0] - dx) / radial, (xy_d[..., 1] - dy) / radial], dim=-1)
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)


class Features(NamedTuple):
    xy_raw: torch.Tensor  # (N, 2) float32 level-0 pixels
    octave: torch.Tensor  # (N,) int64 pyramid level
    angle: torch.Tensor  # (N,) float32 radians
    valid: torch.Tensor  # (N,) bool
    bits: torch.Tensor  # (N, 256) bool BRIEF bits


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def extract(image: torch.Tensor, n_features: int, n_levels: int, scale_factor: float, ini_th: float,
            min_th: float, control: bool = False) -> Features:
    """ORB features of ``image`` ((H, W) float32 in [0, 255]) as the
    port's ``ORBExtractor`` computes them: per-level budgets, the bilinear
    pyramid, FAST + NMS, grid top-k, angle, blur and BRIEF; levels with a
    budget of 0 are skipped. Coordinates are raw (distorted) pixels."""
    budgets = level_budgets(n_features, n_levels, scale_factor)
    levels = [lvl for lvl, b in enumerate(budgets) if b > 0]
    pyramid = build_pyramid(image, n_levels, scale_factor)
    if control:
        pyramid = [_bf16(img) for img in pyramid]
    pattern = torch.as_tensor(ORB_PATTERN, dtype=torch.float32, device=image.device)
    yx, octave, angle, valid, bits, scale = [], [], [], [], [], []
    for lvl in levels:
        img = pyramid[lvl]
        p_yx, _, p_valid = select_keypoints(nms3x3(fast_score(img)), budgets[lvl], ini_th, min_th)
        ang = ic_angle(img, p_yx)
        blur = gaussian_blur7(img)
        if control:
            blur = _bf16(blur)
        yx.append(p_yx)
        valid.append(p_valid)
        angle.append(ang)
        bits.append(brief_descriptors(blur, p_yx, ang, pattern))
        octave.append(torch.full((budgets[lvl],), lvl, dtype=torch.int64, device=image.device))
        scale.append(torch.full((budgets[lvl], 1), float(np.float32(scale_factor**lvl)), device=image.device))
    yx = torch.cat(yx)
    return Features(
        xy_raw=yx.flip(-1).float() * torch.cat(scale),
        octave=torch.cat(octave),
        angle=torch.cat(angle),
        valid=torch.cat(valid),
        bits=torch.cat(bits),
    )
