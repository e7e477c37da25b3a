"""Parity of the port's initialisation path with the JAX package: the
matchers of initialisation, reference-keyframe tracking and new-point
triangulation, DLT triangulation, two-view geometry and the two-view
initialiser.

Tolerances: match indices are exact (Hamming distances are exact in both).
Null vectors from ``eigh`` of A^T A in float32 are conditioned by the square
of the 8th singular value of A, so two LAPACK builds give 8-point
fundamentals that differ by ~1e-2; the two-view geometry and the initialiser
are therefore compared in float64 (the JAX side under ``jax.enable_x64``),
where both agree within 1e-6 and the stated tolerances are 1e-4 for R, t and
F / H up to scale and sign. Triangulation is compared in float32 within
1e-3 relative to depth. Singular and eigen vectors are never compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import frame_to_torch

from orbslam_in_practice_tpu.frontend import matcher as jm
from orbslam_in_practice_tpu.frontend.orb import ORBExtractor as JaxExtractor
from orbslam_in_practice_tpu.geometry import twoview as jtv
from orbslam_in_practice_tpu.geometry.triangulate import triangulate_dlt as jax_triangulate
from orbslam_in_practice_tpu.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu.slam.initializer import initialize_two_view as jax_init
from orbslam_in_practice_tpu_torch.frontend import matcher as tm
from orbslam_in_practice_tpu_torch.geometry import twoview as ttv
from orbslam_in_practice_tpu_torch.geometry.se3 import exp_so3
from orbslam_in_practice_tpu_torch.geometry.triangulate import triangulate_dlt
from orbslam_in_practice_tpu_torch.slam.initializer import N_RANSAC, SAMPLE, initialize_two_view

torch.set_num_threads(2)

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])


@pytest.fixture(scope="module")
def frames():
    """JAX Frames (doubled-budget extractor, 640x480) of frames 0 and 2 of
    the e2e strafe sequence, and of frame 0 of the rotation sequence."""
    ext = JaxExtractor(1200, 1.2, 4, 20.0, 7.0, use_pallas=False)
    strafe = SyntheticSequence(n_frames=3, n_points=700, kind="strafe", seed=3)
    rot = SyntheticSequence(n_frames=3, n_points=700, kind="rotation", seed=3)
    return [ext(jnp.asarray(img)) for img in (strafe.render(0), strafe.render(2), rot.render(2))]


def test_search_for_initialization_exact(frames):
    f0, f2, _ = frames
    prev = np.asarray(f0.xy) + np.float32(3.0)
    for prev_xy in (None, prev):
        want = np.asarray(jm.search_for_initialization(f0, f2, None if prev_xy is None else jnp.asarray(prev_xy)))
        got = tm.search_for_initialization(
            frame_to_torch(f0), frame_to_torch(f2), None if prev_xy is None else torch.from_numpy(prev_xy)
        )
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert (want >= 0).sum() > 100


def test_search_frame_to_kf_exact(frames):
    f0, f2, f_rot = frames
    has_lm = np.asarray(f0.valid) & (np.arange(f0.xy.shape[0]) % 3 != 0)
    for f in (f2, f_rot):
        want = np.asarray(jm.search_frame_to_kf(f, f0.xy, f0.angle, f0.desc_pm1, jnp.asarray(has_lm)))
        t0 = frame_to_torch(f0)
        got = tm.search_frame_to_kf(frame_to_torch(f), t0.xy, t0.angle, t0.desc_pm1, torch.from_numpy(has_lm))
        assert np.array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 0


def test_search_frame_to_kf_ratio_and_batch_exact(frames):
    """Relocalisation's ratio 0.75, and a batch of keyframe lanes (the
    reference vmaps over candidates): each lane equals its single call."""
    f0, f2, f_rot = frames
    n = f0.xy.shape[0]
    lanes = [(f0, np.asarray(f0.valid) & (np.arange(n) % 3 != 0)), (f_rot, np.asarray(f_rot.valid)),
             (f0, np.zeros(n, bool))]
    want = [np.asarray(jm.search_frame_to_kf(f2, kf.xy, kf.angle, kf.desc_pm1, jnp.asarray(has), nn_ratio=0.75))
            for kf, has in lanes]
    tk = [frame_to_torch(kf) for kf, _ in lanes]
    got = tm.search_frame_to_kf(
        frame_to_torch(f2), torch.stack([k.xy for k in tk]), torch.stack([k.angle for k in tk]),
        torch.stack([k.desc_pm1 for k in tk]), torch.from_numpy(np.stack([has for _, has in lanes])), nn_ratio=0.75,
    )
    assert np.array_equal(got.numpy(), np.stack(want))
    assert (want[0] >= 0).sum() > 0 and (want[2] < 0).all()


@pytest.mark.parametrize("pair", [(0, 1), (0, 2)])
def test_match_descriptor_sets_exact(frames, pair):
    """Keyframe-to-keyframe association at loop closing's settings (ratio
    0.9, distance 100, rotation check); ties break as lax.top_k breaks
    them."""
    fa, fb = frames[pair[0]], frames[pair[1]]
    n = fa.xy.shape[0]
    mask_a = np.asarray(fa.valid) & (np.arange(n) % 4 != 0)
    mask_b = np.asarray(fb.valid) & (np.arange(n) % 5 != 1)
    want = np.asarray(jm.match_descriptor_sets(
        fa.desc_pm1, jnp.asarray(mask_a), fb.desc_pm1, jnp.asarray(mask_b), angle_a=fa.angle, angle_b=fb.angle,
        nn_ratio=tm.SETS_NN_RATIO, max_dist=tm.TH_HIGH, check_rotation=True,
    ))
    ta, tb = frame_to_torch(fa), frame_to_torch(fb)
    got = tm.match_descriptor_sets(ta.desc_pm1, torch.from_numpy(mask_a), tb.desc_pm1, torch.from_numpy(mask_b),
                                   ta.angle, tb.angle)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 30


def test_rotation_consistency_ties_exact():
    """Tied bin counts: the 3 largest counts decide, so tied bins are kept
    or dropped together in both packages."""
    rng = np.random.default_rng(4)
    for trial in range(20):
        n = 200
        bins = rng.integers(0, 8, n) * 3  # few bins, many ties
        rot = (bins + 0.5) / 30.0 * 2 * np.pi - 2 * np.pi * rng.integers(-1, 2, n)
        rot = rot.astype(np.float32)
        matched = rng.uniform(size=n) < 0.7
        want = np.asarray(jm._rotation_consistency(jnp.asarray(rot), jnp.asarray(matched)))
        got = tm._rotation_consistency(torch.from_numpy(rot), torch.from_numpy(matched))
        assert np.array_equal(got.numpy(), want), trial


def _kf_pair(frames):
    """Epipolar matching inputs: keyframe 0 and 2 of the strafe sequence,
    with ground-truth-like poses and some features already bound."""
    f0, f2, _ = frames
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[0, 3] = -0.08
    n = f0.xy.shape[0]
    free1 = np.asarray(f0.valid) & (np.arange(n) % 5 != 0)
    free2 = np.asarray(f2.valid) & (np.arange(n) % 7 != 0)
    sf = np.array([1.2**i for i in range(4)], np.float32)
    return f0, f2, T1, T2, free1, free2, (1.0 / sf**2).astype(np.float32)


@pytest.mark.parametrize("max_dist", [jm.TH_LOW, jm.TH_HIGH])
def test_epipolar_match_kf_exact_and_batched(frames, max_dist):
    f0, f2, T1, T2, free1, free2, inv_s2 = _kf_pair(frames)
    F12 = np.asarray(jm.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(K, jnp.float32)))
    F12_t = tm.fundamental_from_poses(torch.from_numpy(T1), torch.from_numpy(T2), torch.tensor(K, dtype=torch.float32))
    assert np.abs(F12_t.numpy() - F12).max() < 1e-6 * np.abs(F12).max()
    args = (f0.xy, f0.desc_pm1, free1, f0.octave, f2.xy, f2.desc_pm1, free2, f2.octave, F12, inv_s2)
    want = np.asarray(jm.epipolar_match_kf(*map(jnp.asarray, args), max_dist=max_dist, angle1=f0.angle, angle2=f2.angle))
    targs = [torch.from_numpy(np.array(a)) for a in args]
    ang1, ang2 = torch.from_numpy(np.array(f0.angle)), torch.from_numpy(np.array(f2.angle))
    got = tm.epipolar_match_kf(*targs, max_dist=max_dist, angle1=ang1, angle2=ang2)
    assert np.array_equal(got.numpy(), want)
    assert (want >= 0).sum() >= 50  # the rotation filter is active
    # a batch of lanes: this pair, the pair with nothing free, the pair again
    lanes = lambda a, empty: torch.stack([a, empty, a])  # noqa: E731
    free_none = torch.zeros_like(targs[6])
    got_b = tm.epipolar_match_kf(
        *targs[:4], lanes(targs[4], targs[4]), lanes(targs[5], targs[5]), lanes(targs[6], free_none),
        lanes(targs[7], targs[7]), lanes(targs[8], targs[8]), targs[9], max_dist=torch.tensor([max_dist] * 3),
        angle1=ang1, angle2=lanes(ang2, ang2),
    )
    assert np.array_equal(got_b[0].numpy(), want) and np.array_equal(got_b[2].numpy(), want)
    assert (got_b[1] < 0).all()


def _rig(rng, n=120, planar=False):
    """A scene and a second camera with a known pose; pixels in both."""
    z = np.full(n, 6.0) if planar else rng.uniform(4.0, 8.0, n)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), z], axis=-1)
    R = exp_so3(torch.from_numpy(rng.normal(size=3) * 0.05)).numpy()
    t = np.array([0.4, 0.02, 0.05])

    def proj(Rm, tv):
        x = pts @ Rm.T + tv
        return (x[:, :2] / x[:, 2:3]) * 500.0 + K[:2, 2]

    noise = rng.normal(size=(2, n, 2)) * 0.3
    return pts, R, t, proj(np.eye(3), np.zeros(3)) + noise[0], proj(R, t) + noise[1]


def test_triangulate_dlt_matches_jax():
    rng = np.random.default_rng(0)
    pts, R, t, p1, p2 = _rig(rng)
    P1 = (K @ np.hstack([np.eye(3), np.zeros((3, 1))])).astype(np.float32)
    P2 = (K @ np.hstack([R, t[:, None]])).astype(np.float32)
    p1, p2 = p1.astype(np.float32), p2.astype(np.float32)
    want = np.asarray(jax_triangulate(jnp.asarray(P1)[None], jnp.asarray(P2)[None], jnp.asarray(p1), jnp.asarray(p2)))
    got = triangulate_dlt(torch.from_numpy(P1), torch.from_numpy(P2), torch.from_numpy(p1), torch.from_numpy(p2))
    assert np.all(np.abs(got.numpy() - want) < 1e-3 * want[:, 2:3])
    assert np.abs(got.numpy() - pts).max() < 0.5  # 0.3 px noise at depths up to 8, baseline 0.4


def _same_up_to_scale(A: np.ndarray, B: np.ndarray) -> float:
    a = A / np.linalg.norm(A, axis=(-2, -1), keepdims=True)
    b = B / np.linalg.norm(B, axis=(-2, -1), keepdims=True)
    return float(np.minimum(np.abs(a - b).max(axis=(-2, -1)), np.abs(a + b).max(axis=(-2, -1))).max())


def _as_set_distance(Rs_a, ts_a, Rs_b, ts_b) -> float:
    """Largest distance from a hypothesis of one set to its nearest in the
    other, both ways."""
    d = np.abs(Rs_a[:, None] - Rs_b[None]).max(axis=(-2, -1)) + np.abs(ts_a[:, None] - ts_b[None]).max(axis=-1)
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


@pytest.mark.parametrize("planar", [False, True])
def test_twoview_geometry_matches_jax_float64(planar):
    rng = np.random.default_rng(1 + planar)
    _, R, t, p1, p2 = _rig(rng, planar=planar)
    mask = rng.uniform(size=len(p1)) < 0.9
    w = np.zeros((6, len(p1)))
    for row in w:  # 8 distinct matches a hypothesis: a 1-dim null space
        row[rng.choice(np.nonzero(mask)[0], 8, replace=False)] = 1.0
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in dict(p1=p1, p2=p2, mask=mask, w=w, K=K).items()}
        x1n, T1 = jtv.normalize_points(j["p1"], j["mask"])
        x2n, T2 = jtv.normalize_points(j["p2"], j["mask"])
        F_j = np.asarray(jax.vmap(lambda ww: jtv.eight_point(x1n, x2n, ww))(j["w"]))
        H_j = np.asarray(jax.vmap(lambda ww: jtv.homography_dlt(x1n, x2n, ww))(j["w"]))
        F_full = T2.T @ jtv.eight_point(x1n, x2n) @ T1
        H_full = jnp.linalg.inv(T2) @ jtv.homography_dlt(x1n, x2n) @ T1
        sF_j, inF_j = (np.asarray(a) for a in jtv.score_fundamental(F_full, j["p1"], j["p2"], j["mask"]))
        sH_j, inH_j = (np.asarray(a) for a in jtv.score_homography(H_full, j["p1"], j["p2"], j["mask"]))
        RE_j, tE_j = (np.asarray(a) for a in jtv.decompose_E(j["K"].T @ F_full @ j["K"]))
        RH_j, tH_j, _ = (np.asarray(a) for a in jtv.decompose_H(H_full, j["K"]))
        n_j, good_j, X_j, par_j = (np.asarray(a) for a in jtv.check_rt(
            jnp.asarray(R), jnp.asarray(t / np.linalg.norm(t)), j["p1"], j["p2"], j["mask"], j["K"]))
        F_full, H_full = np.asarray(F_full), np.asarray(H_full)
    T = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(p1=p1, p2=p2, mask=mask, w=w, K=K).items()}
    tx1n, tT1 = ttv.normalize_points(T["p1"], T["mask"])
    tx2n, tT2 = ttv.normalize_points(T["p2"], T["mask"])
    assert _same_up_to_scale(ttv.eight_point(tx1n, tx2n, T["w"]).numpy(), F_j) < 1e-4
    assert _same_up_to_scale(ttv.homography_dlt(tx1n, tx2n, T["w"]).numpy(), H_j) < 1e-4
    tF = tT2.T @ ttv.eight_point(tx1n, tx2n) @ tT1
    tH = torch.linalg.inv(tT2) @ ttv.homography_dlt(tx1n, tx2n) @ tT1
    assert _same_up_to_scale(tF.numpy(), F_full) < 1e-4
    assert _same_up_to_scale(tH.numpy(), H_full) < 1e-4
    # scoring, given the JAX package's own matrices
    sF, inF = ttv.score_fundamental(torch.from_numpy(F_full), T["p1"], T["p2"], T["mask"])
    sH, inH = ttv.score_homography(torch.from_numpy(H_full), T["p1"], T["p2"], T["mask"])
    assert abs(float(sF) - sF_j) < 1e-6 * abs(sF_j) and np.array_equal(inF.numpy(), inF_j)
    assert abs(float(sH) - sH_j) < 1e-6 * abs(sH_j) and np.array_equal(inH.numpy(), inH_j)
    # decompositions, as sets of hypotheses
    RE, tE = ttv.decompose_E(T["K"].T @ torch.from_numpy(F_full) @ T["K"])
    RH, tH, _ = ttv.decompose_H(torch.from_numpy(H_full), T["K"])
    assert _as_set_distance(RE.numpy(), tE.numpy(), RE_j, tE_j) < 1e-4
    assert _as_set_distance(RH.numpy(), tH.numpy(), RH_j, tH_j) < 1e-4
    n_t, good_t, X_t, par_t = ttv.check_rt(torch.from_numpy(R), torch.from_numpy(t / np.linalg.norm(t)),
                                           T["p1"], T["p2"], T["mask"], T["K"])
    assert int(n_t) == int(n_j) > 50 and np.array_equal(good_t.numpy(), good_j)
    assert np.abs(X_t.numpy() - X_j)[good_j].max() < 1e-6 and abs(float(par_t) - float(par_j)) < 1e-9


def _jax_samples(mask: np.ndarray, dtype) -> np.ndarray:
    """The sample indices of initializer.py:67-69, drawn as it draws them."""
    probs = jnp.asarray(mask.astype(dtype))
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return np.asarray(jax.random.choice(jax.random.PRNGKey(0), len(mask), shape=(N_RANSAC, SAMPLE), replace=True, p=probs))


@pytest.mark.parametrize("planar", [False, True])
def test_initialize_two_view_injected_samples_float64(planar):
    rng = np.random.default_rng(3 + planar)
    _, R, t, p1, p2 = _rig(rng, n=150, planar=planar)
    mask = rng.uniform(size=len(p1)) < 0.9
    p2[~mask] += rng.uniform(-40, 40, (int((~mask).sum()), 2))  # unmatched rows are junk
    with jax.enable_x64(True):
        idx = _jax_samples(mask, np.float64)
        want = jax_init(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), jnp.asarray(K), jax.random.PRNGKey(0))
        want = {k: np.asarray(v) for k, v in want.items()}
    got = initialize_two_view(torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(mask),
                              torch.from_numpy(K), sample_idx=torch.from_numpy(idx.copy()))
    got = {k: v.numpy() for k, v in got.items()}
    assert bool(got["success"]) == bool(want["success"]) is True
    assert bool(got["used_homography"]) == bool(want["used_homography"]) == planar
    assert np.abs(got["R"] - want["R"]).max() < 1e-4
    assert np.abs(got["t"] - want["t"]).max() < 1e-4
    assert np.array_equal(got["good_mask"], want["good_mask"])
    assert int(got["n_good"]) == int(want["n_good"])
    assert abs(float(got["score_F"]) - float(want["score_F"])) < 1e-4 * float(want["score_F"])


def test_initialize_two_view_draws_from_generator():
    """Without injected samples the port draws valid matches only, the same
    ones for the same generator seed, and initialises the rendered pair."""
    rng = np.random.default_rng(5)
    _, R, t, p1, p2 = _rig(rng, n=150)
    mask = rng.uniform(size=len(p1)) < 0.8
    args = [torch.from_numpy(a.astype(np.float32)) for a in (p1, p2)] + [torch.from_numpy(mask), torch.tensor(K, dtype=torch.float32)]
    outs = [initialize_two_view(*args, generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    assert bool(outs[0]["success"]) and np.array_equal(outs[0]["good_mask"].numpy(), outs[1]["good_mask"].numpy())
    assert not outs[0]["good_mask"].numpy()[~mask].any()
    cos_t = float(outs[0]["t"].numpy() @ (t / np.linalg.norm(t)))
    assert np.abs(outs[0]["R"].numpy() - R).max() < 0.02
    assert cos_t > np.cos(0.1)  # direction within 0.1 rad from 0.3 px noise
