"""Bundle adjustment of the plain reference: a frozen copy of the port's
``optim/ba.py`` (SE3 cameras, Schur-marginalised points, Huber kernel,
Levenberg-Marquardt with a fixed number of iterations), plain torch, which
runs in whatever float type its problem holds. The benchmark runs it in
float64 on the problem a local-BA epoch of the timed path solved.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.se3 import exp_se3, hat

CHI2_MONO = 5.991
HUBER_DELTA = CHI2_MONO**0.5

# At or below this camera count the Schur off-diagonal is assembled with
# dense one-hot contractions; above it, landmark chunk by chunk.
DENSE_ASSEMBLY_MAX_CAMS = 64

# The most one-hot elements a row sum (``sum_rows_by_index``) builds at once:
# up to 65,536 observations a chunk at 64 cameras, one chunk in local BA.
ONEHOT_CHUNK_ELEMENTS = 1 << 22


class BAProblem(NamedTuple):
    """Fixed-shape bundle-adjustment problem: K cameras, L landmarks, O
    observations, O_max observations per landmark."""

    poses: torch.Tensor  # (K, 4, 4) Tcw
    points: torch.Tensor  # (L, 3)
    obs_cam: torch.Tensor  # (O,) int64 camera index
    obs_point: torch.Tensor  # (O,) int64 landmark index
    obs_uv: torch.Tensor  # (O, 2) undistorted pixels
    obs_inv_sigma2: torch.Tensor  # (O,) information scale (per octave)
    obs_mask: torch.Tensor  # (O,) bool
    point_obs: torch.Tensor  # (L, O_max) int64 index into the obs arrays, -1 pad
    fixed_cam: torch.Tensor  # (K,) bool: gauge-fixed cameras
    K: torch.Tensor  # (3, 3) intrinsics


def _proj_residual_jac(poses, points, obs_cam, obs_point, obs_uv, Kmat):
    """Per-observation residual r (O, 2), Jacobians Jc (O, 2, 6) and
    Jp (O, 2, 3), and depth z (O,)."""
    Tcw = poses[obs_cam]
    Xw = points[obs_point]
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    pc = (R @ Xw[..., None])[..., 0] + t
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    fx, fy, cx, cy = Kmat[0, 0], Kmat[1, 1], Kmat[0, 2], Kmat[1, 2]
    r = obs_uv - torch.stack([fx * x / z_safe + cx, fy * y / z_safe + cy], dim=-1)

    zi = 1.0 / z_safe
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    J_proj = torch.stack(
        [
            torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1),
            torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1),
        ],
        dim=-2,
    )  # (O, 2, 3)
    eye = torch.eye(3, dtype=poses.dtype, device=poses.device).expand(pc.shape[:-1] + (3, 3))
    Jc = -J_proj @ torch.cat([eye, -hat(pc)], dim=-1)  # left perturbation [rho, phi]
    Jp = -J_proj @ R
    return r, Jc, Jp, z


def _robust_weight(chi2):
    return torch.clamp(HUBER_DELTA / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)


def _robust_cost(chi2):
    d2 = HUBER_DELTA * HUBER_DELTA
    return torch.where(chi2 <= d2, chi2, 2.0 * HUBER_DELTA * torch.sqrt(chi2) - d2)


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def included_obs_mask(point_obs: torch.Tensor, n_obs: int) -> torch.Tensor:
    """(O,) bool: observations that appear in the per-landmark grouping; one
    beyond its landmark's O_max budget is left out of both halves of the
    normal equations."""
    pv = point_obs >= 0
    hits = torch.zeros(n_obs, dtype=torch.int64, device=point_obs.device)
    hits.index_add_(0, torch.clamp(point_obs, min=0).reshape(-1), pv.reshape(-1).to(torch.int64))
    return hits > 0


def _total_cost(poses, points, prob: BAProblem, w_obs):
    r, _, _, _ = _proj_residual_jac(poses, points, prob.obs_cam, prob.obs_point, prob.obs_uv, prob.K)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    return torch.sum(_robust_cost(chi2) * w_obs)


def sum_rows_by_index(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """(n, ...) sums of the rows of ``values`` (R, ...) by ``index`` (R,);
    rows whose index is not in [0, n) are dropped. One-hot products chunk by
    chunk (at most ``ONEHOT_CHUNK_ELEMENTS`` one-hot elements each), so the
    sums run in one fixed order on every run."""
    chunk = max(1, ONEHOT_CHUNK_ELEMENTS // max(n, 1))
    flat = values.reshape(values.shape[0], -1)
    out = flat.new_zeros((n, flat.shape[1]))
    cols = torch.arange(n, device=values.device)
    for s in range(0, flat.shape[0], chunk):
        out = out + (index[s : s + chunk, None] == cols).to(flat.dtype).T @ flat[s : s + chunk]
    return out.reshape((n,) + values.shape[1:])


def build_normal_equations(poses, points, prob: BAProblem):
    """Assemble the Schur system's blocks.

    Returns (Hcc (K, 6, 6), b_c (K, 6), Hpp (L, 3, 3), b_p (L, 3),
    Wg (L, O_max, 6, 3), cam_g (L, O_max), pv (L, O_max), w_g (L, O_max)).
    """
    dtype = poses.dtype
    n_cam = poses.shape[0]
    r, Jc, Jp, _ = _proj_residual_jac(poses, points, prob.obs_cam, prob.obs_point, prob.obs_uv, prob.K)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    included = included_obs_mask(prob.point_obs, prob.obs_cam.shape[0])
    w = (prob.obs_mask & included).to(dtype) * prob.obs_inv_sigma2 * _robust_weight(chi2)

    Jc_w = Jc * w[:, None, None]
    Hcc_obs = Jc_w.transpose(-1, -2) @ Jc  # (O, 6, 6)
    b_obs = -(Jc_w.transpose(-1, -2) @ r[..., None])[..., 0]  # (O, 6)
    Hcc = sum_rows_by_index(Hcc_obs, prob.obs_cam, n_cam)
    b_c = sum_rows_by_index(b_obs, prob.obs_cam, n_cam)

    # landmark blocks, grouped by point
    po = prob.point_obs
    pv = po >= 0
    po_safe = torch.clamp(po, min=0)
    pvf = pv.to(dtype)
    Jp_g = Jp[po_safe] * pvf[..., None, None]  # (L, O_max, 2, 3)
    Jc_g = Jc[po_safe] * pvf[..., None, None]  # (L, O_max, 2, 6)
    r_g = r[po_safe] * pvf[..., None]
    w_g = w[po_safe] * pvf
    cam_g = torch.where(pv, prob.obs_cam[po_safe], 0)

    Jp_w = Jp_g * w_g[..., None, None]
    Hpp = torch.einsum("loai,loaj->lij", Jp_w, Jp_g)
    b_p = -torch.einsum("loai,loa->li", Jp_w, r_g)
    Wg = torch.einsum("loai,loaj->loij", Jc_g * w_g[..., None, None], Jp_g)
    return Hcc, b_c, Hpp, b_p, Wg, cam_g, pv, w_g


def schur_offdiag_chunked(T, Wg, contrib, cam_g, pv, n_cam, chunk=1024):
    """The Schur off-diagonal for many cameras, landmark chunk by chunk: per
    chunk the per-camera sums A, B of T and Wg factor the off-diagonal into
    one (K*6, C*3) @ (C*3, K*6) product. Returns (-S_offdiag (K, K, 6, 6),
    -b_contrib (K, 6))."""
    dtype, device = T.dtype, T.device
    L_ = cam_g.shape[0]
    k6 = n_cam * 6
    S = torch.zeros((k6, k6), dtype=dtype, device=device)
    b = torch.zeros((n_cam, 6), dtype=dtype, device=device)
    cams = torch.arange(n_cam, device=device)
    for s in range(0, L_, chunk):
        e = min(s + chunk, L_)
        c = e - s
        E = ((cam_g[s:e, :, None] == cams) & pv[s:e, :, None]).to(dtype)  # (C, O_max, K) one-hot
        Am = torch.einsum("lok,loij->ljki", E, T[s:e]).reshape(c * 3, k6)
        Bm = torch.einsum("lok,loij->ljki", E, Wg[s:e]).reshape(c * 3, k6)
        S = S - Am.T @ Bm
        b = b - torch.einsum("lok,loi->ki", E, contrib[s:e])
    return S.reshape(n_cam, 6, n_cam, 6).permute(0, 2, 1, 3), b


def schur_solve(Hcc, b_c, Hpp, b_p, Wg, cam_g, pv, fixed_cam, lam):
    """Damp, form the Schur complement, solve the cameras, back-substitute
    the landmarks. Returns (delta_c (K, 6), delta_p (L, 3))."""
    dtype, device = Hcc.dtype, Hcc.device
    n_cam = Hcc.shape[0]
    eye6 = torch.eye(6, dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_inv = _inv3x3(Hpp + lam * Hpp * eye3 + 1e-8 * eye3)

    T = Wg @ Hpp_inv[:, None]  # (L, O_max, 6, 3): W Hpp^-1
    contrib = (T @ b_p[:, None, :, None])[..., 0]  # (L, O_max, 6)
    cam_eye = torch.eye(n_cam, dtype=dtype, device=device)[:, :, None, None]
    if n_cam <= DENSE_ASSEMBLY_MAX_CAMS:
        # a landmark has at most one observation per camera, so its Schur
        # term factors through per-camera sums A = E^T T, B = E^T W
        E = ((cam_g[..., None] == torch.arange(n_cam, device=device)) & pv[..., None]).to(dtype)
        A = torch.einsum("lok,loij->lkij", E, T)
        B = torch.einsum("lok,loij->lkij", E, Wg)
        S = -torch.einsum("lkiz,lqjz->kqij", A, B) + cam_eye * Hcc_d[:, None]
        b_red = b_c - torch.einsum("lok,loi->ki", E, contrib)
    else:
        S_neg, b_neg = schur_offdiag_chunked(T, Wg, contrib, cam_g, pv, n_cam)
        S = S_neg + cam_eye * Hcc_d[:, None]
        b_red = b_c + b_neg

    # gauge: fixed cameras' rows and columns zeroed, identity diagonal
    free = (~fixed_cam).to(dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S = S + cam_eye * (eye6 * fixed_cam.to(dtype)[:, None, None])[:, None]
    b_red = b_red * free[:, None]

    S_mat = S.permute(0, 2, 1, 3).reshape(n_cam * 6, n_cam * 6)
    delta_c = torch.linalg.solve_ex(S_mat, b_red.reshape(-1))[0].reshape(n_cam, 6)

    dc_g = delta_c[cam_g] * pv[..., None].to(dtype)  # (L, O_max, 6)
    Wt_dc = torch.einsum("loij,loi->lj", Wg, dc_g)
    delta_p = (Hpp_inv @ (b_p - Wt_dc)[..., None])[..., 0]
    return delta_c, delta_p


def lm_iteration(poses, points, lam, prob: BAProblem, w_obs):
    """One Levenberg-Marquardt iteration: assemble, Schur-solve, and accept
    the step on the device when it lowers the cost. Returns (poses, points,
    lam)."""
    Hcc, b_c, Hpp, b_p, Wg, cam_g, pv, _ = build_normal_equations(poses, points, prob)
    delta_c, delta_p = schur_solve(Hcc, b_c, Hpp, b_p, Wg, cam_g, pv, prob.fixed_cam, lam)
    free = (~prob.fixed_cam)[:, None].to(poses.dtype)
    poses_new = exp_se3(delta_c * free) @ poses
    points_new = points + delta_p
    cost_old = _total_cost(poses, points, prob, w_obs)
    cost_new = _total_cost(poses_new, points_new, prob, w_obs)
    ok = torch.isfinite(cost_new) & (cost_new < cost_old)
    return (
        torch.where(ok, poses_new, poses),
        torch.where(ok, points_new, points),
        torch.where(ok, lam * 0.5, lam * 4.0),
    )


def bundle_adjustment(prob: BAProblem, iterations: int = 20):
    """Full or local BA by LM + Schur. Returns (poses (K, 4, 4), points
    (L, 3), chi2 per observation (O,), inf where the point is behind the
    camera). Landmarks without observations get zero updates."""
    included = included_obs_mask(prob.point_obs, prob.obs_cam.shape[0])
    w_obs = (prob.obs_mask & included).to(prob.poses.dtype)
    poses, points = prob.poses, prob.points
    lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
    for _ in range(iterations):
        poses, points, lam = lm_iteration(poses, points, lam, prob, w_obs)
    r, _, _, z = _proj_residual_jac(poses, points, prob.obs_cam, prob.obs_point, prob.obs_uv, prob.K)
    chi2 = torch.sum(r * r, dim=-1) * prob.obs_inv_sigma2
    return poses, points, torch.where(z > 0, chi2, torch.full_like(chi2, float("inf")))
