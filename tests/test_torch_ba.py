"""Parity of the port's bundle adjustment with the JAX package.

Exact: ``build_point_obs``, ``adaptive_o_max``, ``count_obs_drops`` and the
included-observation mask (integer bookkeeping). Within tolerance: the
chunked Schur off-diagonal (2e-4, float32 sums in another order) and whole
bundle adjustments, at 2 cameras (the initial map's BA, one camera fixed)
and at 70 cameras (the chunked Schur path above DENSE_ASSEMBLY_MAX_CAMS),
from the same perturbed start: poses within 1e-3, points within 1e-3 of
their depth, and per-observation chi2 within 1e-2 absolute or 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu.optim import ba as jba
from orbslam_in_practice_tpu_torch.geometry.se3 import exp_se3, exp_so3
from orbslam_in_practice_tpu_torch.optim import ba as tba

torch.set_num_threads(2)

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)


def _problem(rng, n_cams: int, n_pts: int, n_fixed: int):
    """Cameras strafing along x (0.3 apart, small rotations), points in
    front; a point is observed by the cameras it projects into, with 0.5 px
    noise, and kept when seen by >= 3 (or by both of 2). Every observation is in the
    per-landmark grouping. Returns the numpy fields of a BAProblem, the
    start perturbed, and the true points."""
    span = 0.3 * (n_cams - 1)
    pts = np.stack([rng.uniform(-1.0, span + 1.0, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(4.0, 8.0, n_pts)], -1)
    poses = np.tile(np.eye(4), (n_cams, 1, 1))
    for c in range(n_cams):
        poses[c, :3, :3] = exp_so3(torch.from_numpy(rng.normal(size=3) * 0.01)).numpy()
        poses[c, :3, 3] = -poses[c, :3, :3] @ np.array([0.3 * c, 0.01 * np.sin(c), 0.0])
    obs_cam, obs_point, obs_uv = [], [], []
    for c in range(n_cams):
        pc = pts @ poses[c, :3, :3].T + poses[c, :3, 3]
        uv = pc[:, :2] / pc[:, 2:3] * 500.0 + K[:2, 2]
        seen = np.nonzero((uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480))[0]
        obs_cam += [c] * len(seen)
        obs_point += list(seen)
        obs_uv.append(uv[seen] + rng.normal(size=(len(seen), 2)) * 0.5)
    obs_uv = np.concatenate(obs_uv)
    obs_cam, obs_point = np.asarray(obs_cam), np.asarray(obs_point)
    keep_pt = np.bincount(obs_point, minlength=n_pts) >= min(3, n_cams)
    keep = keep_pt[obs_point]
    new_id = np.cumsum(keep_pt) - 1
    obs_cam, obs_point, obs_uv, pts = obs_cam[keep], new_id[obs_point[keep]], obs_uv[keep], pts[keep_pt]
    n_pts = len(pts)
    start = poses.copy()
    for c in range(n_fixed, n_cams):
        xi = np.r_[rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.005]
        start[c] = exp_se3(torch.from_numpy(xi)).numpy() @ start[c]
    fixed = np.arange(n_cams) < n_fixed
    n_obs = len(obs_point)
    o_max = int(np.bincount(obs_point).max())
    return dict(
        poses=start.astype(np.float32),
        points=(pts + rng.normal(size=pts.shape) * 0.05).astype(np.float32),
        obs_cam=np.asarray(obs_cam, np.int32),
        obs_point=obs_point.astype(np.int32),
        obs_uv=obs_uv.astype(np.float32),
        obs_inv_sigma2=(1.2 ** -(2.0 * rng.integers(0, 3, n_obs))).astype(np.float32),
        obs_mask=rng.uniform(size=n_obs) < 0.98,
        point_obs=jba.build_point_obs(obs_point, n_pts, o_max),
        fixed_cam=fixed,
        K=K,
    ), pts


def _run_both(fields, iterations):
    want = jba.bundle_adjustment(jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}), iterations=iterations)
    tfields = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()}
    for k in ("obs_cam", "obs_point", "point_obs"):
        tfields[k] = tfields[k].long()
    got = tba.bundle_adjustment(tba.BAProblem(**tfields), iterations=iterations)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize(
    "n_cams,n_pts,n_fixed,iterations",
    [(2, 150, 1, 20), (70, 300, 2, 3)],
    ids=["2cams-initial", "70cams-chunked"],
)
def test_bundle_adjustment_matches_jax(n_cams, n_pts, n_fixed, iterations):
    rng = np.random.default_rng(n_cams)
    fields, pts = _problem(rng, n_cams, n_pts, n_fixed)
    if n_cams > tba.DENSE_ASSEMBLY_MAX_CAMS:
        assert n_cams > jba.DENSE_ASSEMBLY_MAX_CAMS
    (P_j, X_j, c_j), (P_t, X_t, c_t) = _run_both(fields, iterations)
    assert np.abs(P_t - P_j).max() < 1e-3
    assert np.all(np.abs(X_t - X_j) < 1e-3 * pts[:, 2:3])
    fin = np.isfinite(c_j)
    assert np.array_equal(np.isfinite(c_t), fin)
    assert np.all(np.abs(c_t - c_j)[fin] < np.maximum(1e-2, 1e-2 * c_j[fin]))
    # the solve moved the free cameras toward the truth
    assert np.array_equal(P_t[:n_fixed], fields["poses"][:n_fixed])
    assert np.median(c_t[fin & fields["obs_mask"]]) < 2.0


def test_schur_offdiag_chunked_matches_jax():
    rng = np.random.default_rng(7)
    L, O, Kc = 37, 5, 9
    T = rng.normal(size=(L, O, 6, 3)).astype(np.float32)
    Wg = rng.normal(size=(L, O, 6, 3)).astype(np.float32)
    contrib = rng.normal(size=(L, O, 6)).astype(np.float32)
    cam_g = rng.integers(0, Kc, (L, O))
    pv = rng.uniform(size=(L, O)) < 0.8
    S_j, b_j = jba.schur_offdiag_chunked(*map(jnp.asarray, (T, Wg, contrib, cam_g.astype(np.int32), pv)), Kc, chunk=8)
    for chunk in (8, 1024):
        S_t, b_t = tba.schur_offdiag_chunked(*map(torch.from_numpy, (T, Wg, contrib, cam_g, pv)), Kc, chunk=chunk)
        np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=2e-4)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=2e-4)


@pytest.mark.parametrize("n, chunk_elements", [(9, 1 << 22), (9, 64), (70, 140)])
def test_sum_rows_by_index_matches_segment_sum(monkeypatch, n, chunk_elements):
    """The camera blocks' one-hot sums, in one chunk or in several, equal
    the JAX package's segment sum (rows indexed out of range dropped)."""
    import jax

    monkeypatch.setattr(tba, "ONEHOT_CHUNK_ELEMENTS", chunk_elements)
    rng = np.random.default_rng(n)
    values = rng.normal(size=(301, 6, 6)).astype(np.float32)
    index = rng.integers(0, n + 2, 301)
    want = jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(index.astype(np.int32)), num_segments=n)
    got = tba.sum_rows_by_index(torch.from_numpy(values), torch.from_numpy(index), n)
    assert got.shape == (n, 6, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_build_point_obs_exact():
    rng = np.random.default_rng(2)
    for n_points, o_max in ((37, 4), (200, 12), (5, 1)):
        obs_point = rng.integers(-1, n_points + 3, size=400).astype(np.int32)
        want = jba.build_point_obs(obs_point, n_points, o_max)
        got = tba.build_point_obs(obs_point, n_points, o_max)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert tba.count_obs_drops(obs_point, n_points, o_max) == jba.count_obs_drops(obs_point, n_points, o_max)
        inc_j = np.asarray(jba.included_obs_mask(jnp.asarray(want), len(obs_point)))
        inc_t = tba.included_obs_mask(torch.from_numpy(got).long(), len(obs_point)).numpy()
        assert np.array_equal(inc_t, inc_j)


@pytest.mark.parametrize("max_count", [1, 5, 12, 13, 17, 30, 47, 100])
def test_adaptive_o_max_exact(max_count):
    for base, cap in ((12, 48), (12, 32), (4, 16)):
        assert tba.adaptive_o_max(max_count, base, cap) == jba.adaptive_o_max(max_count, base, cap)


def test_inv3x3_matches_jax():
    M = np.random.default_rng(3).normal(size=(64, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tba._inv3x3(torch.from_numpy(M)).numpy(), np.asarray(jba._inv3x3(jnp.asarray(M))), rtol=1e-6, atol=1e-6)
