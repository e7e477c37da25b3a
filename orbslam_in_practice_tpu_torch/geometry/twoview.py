"""Two-view epipolar geometry: normalised 8-point, H-DLT, decompositions.

Port of ``orbslam_in_practice_tpu/geometry/twoview.py``: point
normalisation, the 8-point fundamental and homography DLT (null vectors by
``eigh`` of A^T A), symmetric-transfer chi2 scoring, E decomposition into 4
and Faugeras H decomposition into 8 (R, t) hypotheses, and CheckRT gating.
Everything broadcasts over leading batch dims (the reference vmaps over
RANSAC hypotheses). Singular and eigen vectors are defined up to sign, so
only what is invariant to it is compared with the reference.
"""

from __future__ import annotations

import torch

from orbslam_in_practice_tpu_torch.geometry.triangulate import triangulate_dlt

CHI2_1DOF = 3.841
CHI2_2DOF = 5.991
MIN_PARALLAX_COS = 0.99998  # check_rt's parallax gate


def normalize_points(pts: torch.Tensor, mask: torch.Tensor | None = None):
    """Mean / mean-absolute-deviation normalisation of (N, 2) points.

    Returns (pts_norm (N, 2), T (3, 3)) with pts_norm = T @ [pts; 1].
    """
    if mask is None:
        mask = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=0) / n
    dev = torch.sum(torch.abs(pts - mean) * w[..., None], dim=0) / n
    s = 1.0 / torch.clamp(dev, min=1e-8)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack(
        [
            torch.stack([s[0], zero, -mean[0] * s[0]]),
            torch.stack([zero, s[1], -mean[1] * s[1]]),
            torch.stack([zero, zero, one]),
        ]
    )
    return (pts - mean) * s, T


def _min_eigvec(AtA: torch.Tensor) -> torch.Tensor:
    return torch.linalg.eigh(AtA)[1][..., :, 0]


def eight_point(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 3, 3) rank-2 fundamental with x2' F x1 = 0 from normalised
    points x1, x2 (..., N, 2), weighted by w (..., N)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], dim=-1)
    if w is not None:
        A = A * w[..., None]
    f = _min_eigvec(A.transpose(-1, -2) @ A)
    F = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vh


def homography_dlt(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Homography H21 (x2 ~ H x1) from normalised points (..., N, 2),
    weighted by w (..., N)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    row1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    row2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([row1, row2], dim=-2)  # (..., 2N, 9)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    h = _min_eigvec(A.transpose(-1, -2) @ A)
    return h.reshape(h.shape[:-1] + (3, 3))


def _hom(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def score_fundamental(F, p1, p2, mask):
    """Symmetric epipolar-transfer chi2 score of F ([B,] 3, 3) on (N, 2)
    matches at a 1-pixel sigma: a match is an inlier when both directed
    errors pass CHI2_1DOF; the score sums (CHI2_2DOF - chi2) of each passing
    direction.

    Returns (score ([B,]), inliers ([B,] N))."""
    h1, h2 = _hom(p1), _hom(p2)
    l2 = h1 @ F.transpose(-1, -2)
    num2 = torch.sum(l2 * h2, dim=-1)
    chi2_2 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    l1 = h2 @ F
    num1 = torch.sum(l1 * h1, dim=-1)
    chi2_1 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    ok2 = chi2_2 <= CHI2_1DOF
    ok1 = chi2_1 <= CHI2_1DOF
    zero = torch.zeros_like(chi2_1)
    score = torch.sum(
        torch.where(mask & ok2, CHI2_2DOF - chi2_2, zero) + torch.where(mask & ok1, CHI2_2DOF - chi2_1, zero),
        dim=-1,
    )
    return score, mask & ok1 & ok2


def _dehom(q: torch.Tensor) -> torch.Tensor:
    w = q[..., 2:3]
    return q[..., :2] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def score_homography(H21, p1, p2, mask):
    """Symmetric transfer chi2 score of H21 ([B,] 3, 3) at a 1-pixel sigma,
    per-match inlier flags at CHI2_2DOF. Returns (score ([B,]), inliers
    ([B,] N))."""
    H12 = torch.linalg.inv_ex(H21)[0]  # no error check: a singular H scores nothing
    h1, h2 = _hom(p1), _hom(p2)
    chi2_2 = torch.sum((p2 - _dehom(h1 @ H21.transpose(-1, -2))) ** 2, dim=-1)
    chi2_1 = torch.sum((p1 - _dehom(h2 @ H12.transpose(-1, -2))) ** 2, dim=-1)
    ok2 = chi2_2 <= CHI2_2DOF
    ok1 = chi2_1 <= CHI2_2DOF
    zero = torch.zeros_like(chi2_1)
    score = torch.sum(
        torch.where(mask & ok2, CHI2_2DOF - chi2_2, zero) + torch.where(mask & ok1, CHI2_2DOF - chi2_1, zero),
        dim=-1,
    )
    return score, mask & ok1 & ok2


def decompose_E(E: torch.Tensor):
    """Essential matrix -> 4 (R, t) hypotheses: (R (4, 3, 3), t (4, 3))."""
    U, _, Vh = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_H(H21: torch.Tensor, K: torch.Tensor):
    """Faugeras SVD decomposition of a homography -> 8 hypotheses:
    (R (8, 3, 3), t (8, 3) unit-norm, n (8, 3) facing the camera)."""
    dtype, device = H21.dtype, H21.device
    A = torch.linalg.inv(K) @ H21 @ K
    U, d, Vh = torch.linalg.svd(A)
    V = Vh.transpose(-1, -2)
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = d[0], d[1], d[2]

    def signs(*v):
        return torch.tensor(v, dtype=dtype, device=device)

    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    x1 = signs(1.0, 1.0, -1.0, -1.0) * aux1  # (4,)
    x3 = signs(1.0, -1.0, 1.0, -1.0) * aux3
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)

    # case d' = d2
    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / den_p
    st = signs(1.0, -1.0, -1.0, 1.0) * (root / den_p)
    ct4 = ct.expand(4)
    Rp_pos = torch.stack(
        [torch.stack([ct4, zero, -st], -1), torch.stack([zero, one, zero], -1), torch.stack([st, zero, ct4], -1)],
        dim=-2,
    )
    tp_pos = torch.stack([x1, zero, -x3], -1) * (d1 - d3)

    # case d' = -d2
    den_n = torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / den_n
    sp = signs(1.0, -1.0, -1.0, 1.0) * (root / den_n)
    cp4 = cp.expand(4)
    Rp_neg = torch.stack(
        [torch.stack([cp4, zero, sp], -1), torch.stack([zero, -one, zero], -1), torch.stack([sp, zero, -cp4], -1)],
        dim=-2,
    )
    tp_neg = torch.stack([x1, zero, x3], -1) * (d1 + d3)

    Rp = torch.cat([Rp_pos, Rp_neg])  # (8, 3, 3)
    tp = torch.cat([tp_pos, tp_neg])  # (8, 3)
    n_p = torch.stack([x1, zero, x3], -1).repeat(2, 1)
    R8 = s * (U @ Rp @ Vh)
    t8 = (U @ tp[..., None])[..., 0]
    n8 = (V @ n_p[..., None])[..., 0]
    t8 = t8 / torch.clamp(torch.linalg.vector_norm(t8, dim=-1, keepdim=True), min=1e-12)
    n8 = n8 * torch.where(n8[..., 2:3] < 0, -1.0, 1.0)
    return R8, t8, n8


def check_rt(
    R: torch.Tensor,
    t: torch.Tensor,
    p1: torch.Tensor,
    p2: torch.Tensor,
    mask: torch.Tensor,
    K: torch.Tensor,
):
    """Cheirality / parallax / reprojection gating of (R, t) hypotheses:
    triangulate every masked match, require finite points, parallax cosine
    under MIN_PARALLAX_COS, positive depth in both views and squared
    reprojection error < 4 px^2 (a 1-pixel sigma) in both.

    R ([B,] 3, 3), t ([B,] 3); p1, p2 (N, 2); mask ([B,] N).
    Returns (n_good ([B,]), good ([B,] N), points3d ([B,] N, 3) in the
    camera-1 frame, parallax cosine of the 51st most parallax good point).
    """
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    P1 = K @ torch.cat([eye, torch.zeros_like(eye[:, :1])], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_dlt(P1, P2[..., None, :, :], p1, p2)  # ([B,] N, 3)

    finite = torch.all(torch.isfinite(X), dim=-1)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # camera-2 centre
    ray2 = X - O2[..., None, :]
    cos_par = torch.sum(X * ray2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(X, dim=-1) * torch.linalg.vector_norm(ray2, dim=-1), min=1e-12
    )
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z1s, z2s = torch.clamp(z1, min=1e-12), torch.clamp(z2, min=1e-12)
    e1 = (fx * X[..., 0] / z1s + cx - p1[..., 0]) ** 2 + (fy * X[..., 1] / z1s + cy - p1[..., 1]) ** 2
    e2 = (fx * X2[..., 0] / z2s + cx - p2[..., 0]) ** 2 + (fy * X2[..., 1] / z2s + cy - p2[..., 1]) ** 2
    good = mask & finite & (z1 > 0) & (z2 > 0) & (cos_par < MIN_PARALLAX_COS) & (e1 < 4.0) & (e2 < 4.0)
    n_good = torch.sum(good, dim=-1)
    order = torch.sort(torch.where(good, cos_par, torch.ones_like(cos_par)), dim=-1).values
    idx = torch.clamp(torch.clamp(n_good - 1, max=50), 0, p1.shape[0] - 1)
    parallax_cos = torch.gather(order, -1, idx[..., None])[..., 0]
    return n_good, good, X, parallax_cos
