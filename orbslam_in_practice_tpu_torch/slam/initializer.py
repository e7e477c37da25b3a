"""Monocular two-view bootstrap: batched RANSAC H/F + model select + CheckRT.

Port of ``orbslam_in_practice_tpu/slam/initializer.py``: 200 hypotheses of
8 matches each for both a homography and a fundamental matrix, each model's
batch fitted and scored at once; the homography wins when S_H / (S_H + S_F)
> 0.45; its decomposition's hypotheses (8 for H, 4 for F) are gated by
CheckRT and the winner must be decisive and have parallax.

The reference draws its samples with ``jax.random.choice``, whose stream
torch cannot reproduce; here the samples are either given (``sample_idx``)
or drawn, with the same weighting and replacement, from a
``torch.Generator``.
"""

from __future__ import annotations

import torch

from orbslam_in_practice_tpu_torch.geometry.twoview import (
    check_rt,
    decompose_E,
    decompose_H,
    eight_point,
    homography_dlt,
    normalize_points,
    score_fundamental,
    score_homography,
)

N_RANSAC = 200
SAMPLE = 8
MIN_INLIERS = 50  # fewest good points a successful initialisation keeps


def ransac_samples(
    match_mask: torch.Tensor,
    generator: torch.Generator | None = None,
    n_hyp: int = N_RANSAC,
    size: int = SAMPLE,
) -> torch.Tensor:
    """(n_hyp, size) int64 indices of ``match_mask``'s true entries, drawn
    with replacement, each equally likely (``jax.random.choice(key, n,
    (n_hyp, size), replace=True, p=mask / mask.sum())`` of the reference)."""
    probs = match_mask.to(torch.float32)
    probs = probs / torch.clamp(torch.sum(probs), min=1.0)
    idx = torch.multinomial(probs, n_hyp * size, replacement=True, generator=generator)
    return idx.reshape(n_hyp, size)


def initialize_two_view(
    p1: torch.Tensor,
    p2: torch.Tensor,
    match_mask: torch.Tensor,
    K: torch.Tensor,
    sample_idx: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict:
    """Two-view relative pose + structure from matched undistorted points.

    p1, p2: (N, 2) index-aligned matched pixels in frame 1 / frame 2,
    masked by match_mask (N,) bool; K (3, 3). sample_idx: optional
    (N_RANSAC, SAMPLE) int64 indices into the matches; drawn from
    ``generator`` when absent.

    Returns a dict of tensors: success, R (3, 3), t (3,), points3d (N, 3) in
    frame-1 camera coords, good_mask (N,), used_homography, n_good, score_F,
    score_H.
    """
    n = p1.shape[0]
    dtype, device = p1.dtype, p1.device
    x1n, T1 = normalize_points(p1, match_mask)
    x2n, T2 = normalize_points(p2, match_mask)

    if sample_idx is None:
        sample_idx = ransac_samples(match_mask, generator)
    sample_idx = sample_idx.to(device=device, dtype=torch.int64)
    sample_w = torch.zeros((N_RANSAC, n), dtype=dtype, device=device)
    sample_w.scatter_(1, sample_idx, 1.0)

    # fundamental batch
    Fs = T2.T @ eight_point(x1n, x2n, sample_w) @ T1
    sF, inlF = score_fundamental(Fs, p1, p2, match_mask)
    bF = torch.argmax(sF)
    score_F, F_best, inliers_F = sF[bF], Fs[bF], inlF[bF]

    # homography batch
    Hs = torch.linalg.inv(T2) @ homography_dlt(x1n, x2n, sample_w) @ T1
    sH, inlH = score_homography(Hs, p1, p2, match_mask)
    bH = torch.argmax(sH)
    score_H, H_best, inliers_H = sH[bH], Hs[bH], inlH[bH]

    rh = score_H / torch.clamp(score_H + score_F, min=1e-9)
    use_H = rh > 0.45

    # decompose both, evaluate the hypotheses of the selected model (the F
    # hypotheses padded to 8, the padding invalid)
    R_f, t_f = decompose_E(K.T @ F_best @ K)
    R_h, t_h, _ = decompose_H(H_best, K)
    eye = torch.eye(3, dtype=dtype, device=device)
    R_f8 = torch.cat([R_f, eye.expand(4, 3, 3)])
    t_f8 = torch.cat([t_f, torch.ones((4, 3), dtype=dtype, device=device)])
    R8 = torch.where(use_H, R_h, R_f8)
    t8 = torch.where(use_H, t_h, t_f8)
    hyp_valid = use_H | (torch.arange(8, device=device) < 4)
    inliers = torch.where(use_H, inliers_H, inliers_F)

    n_good8, good8, X8, par8 = check_rt(R8, t8, p1, p2, inliers, K)
    n_good8 = torch.where(hyp_valid, n_good8, -1)
    best = torch.argmax(n_good8)
    n_best = n_good8[best]
    n_second = torch.sort(n_good8).values[-2]
    n_inliers = torch.sum(inliers)
    enough = n_best >= torch.clamp((0.8 * n_inliers).to(torch.int64), min=MIN_INLIERS)
    decisive = n_second.to(dtype) < 0.85 * n_best.to(dtype)
    has_parallax = par8[best] < 0.99995
    return {
        "success": enough & decisive & has_parallax,
        "R": R8[best],
        "t": t8[best],
        "points3d": X8[best],
        "good_mask": good8[best],
        "used_homography": use_H,
        "n_good": n_best,
        "score_F": score_F,
        "score_H": score_H,
    }
