"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one. The file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel A is bit-exact (subtraction, min and max in float32).
Kernel B's angles agree within 1e-3 rad and its descriptor bits on > 99.5%
(the kernel sums the moments in another order and rotates the pattern by the
normalised moments, not by cos/sin of the angle); its ±1 rows equal
``unpack_to_pm1`` of its words exactly. Each kernel runs once over every
pyramid level: the bench's 4 levels of a 640x480 frame and TUM1's 8. Bundle adjustment on the
card against the CPU: poses within 1e-3 and points within 1e-3 of their
depth (the devices sum in other orders); two runs on the card give the same
bits. The system on
the card: state OK after the e2e sequence's first 16 frames, both kernels
launched, and the map's device tables equal to its host truth; built as the
JAX package is, ``SlamSystem(config, bow_path)``, it lives on the card, and
after the distorted strafe's first 8 frames its last frame is the fused
step's, on the card, with undistorted coordinates apart from the raw ones. The
pose-graph optimisation on the card against the CPU on a drifted chain:
vertices within 1e-3; on a 48-keyframe graph, the same bits on every run. Relocalisation on the card against the CPU, with the
same RANSAC samples: the same outcome, keyframe, observations and inlier
count, Tcw within 1e-3; and the loop closer's Sim3 RANSAC likewise: the
same inlier count, s, R, t within 1e-3. Asynchronous mapping on the card:
the worker queues on the default stream, its epochs all run, the device
tables equal host truth, one launch of each kernel per extraction.
Distributed BA in a one-rank NCCL group against the CPU without a group:
poses and points within 1e-4.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_parity import SMALL, cuda_device, rendered_frame, wrapped_angle_error  # noqa: F401

from orbslam_in_practice_tpu_torch.bench_state import build_bench_state
from orbslam_in_practice_tpu_torch.config import SlamConfig, load_config
from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor
from orbslam_in_practice_tpu_torch.ops.cuda_fast import (
    MAX_LEVELS,
    fast_score_nms,
    fast_score_nms_levels,
    fast_score_nms_plain,
)
from orbslam_in_practice_tpu_torch.ops.cuda_patch import (
    orb_patch_features,
    orb_patch_features_levels,
    orb_patch_features_levels_plain,
    orb_patch_features_plain,
)
from orbslam_in_practice_tpu_torch.ops.hamming import unpack_bits, unpack_to_pm1
from orbslam_in_practice_tpu_torch.ops.image import build_pyramid
from orbslam_in_practice_tpu_torch.ops.orb import level_budgets, orb_pattern, select_keypoints
from orbslam_in_practice_tpu_torch.frontend.frame import Frame
from orbslam_in_practice_tpu_torch.geometry.se3 import exp_so3
from orbslam_in_practice_tpu_torch.geometry.sim3_lie import exp_sim3
from orbslam_in_practice_tpu_torch.optim.ba import BAProblem, build_point_obs, bundle_adjustment
from orbslam_in_practice_tpu_torch.optim.pose_graph import optimize_pose_graph
from orbslam_in_practice_tpu_torch.slam.loop_closing import N_HYP, sim3_ransac
from orbslam_in_practice_tpu_torch.slam.map import SlamMap
from orbslam_in_practice_tpu_torch.slam.relocalization import relocalize
from orbslam_in_practice_tpu_torch.slam.tracking import FusedSteadyStep, TrackingState
from orbslam_in_practice_tpu_torch.system import SlamSystem

pytestmark = pytest.mark.cuda

ANGLE_TOL = 1e-3
BIT_TOL = 0.005
# keypoints at the 19 px border of a 96x128 image, and a padding row at (0, 0)
BORDER_YX = np.array([[19, 19], [96 - 20, 128 - 20], [19, 128 - 20], [96 - 20, 19], [0, 0]], np.int32)


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(480, 640), (278, 370), (376, 1241), (37, 45)])
def test_fast_kernel_bit_exact(cuda_device, shape):  # noqa: F811
    img = torch.from_numpy(_image(shape, seed=3)).to(cuda_device)
    before = fast_score_nms.launches
    got = fast_score_nms(img)
    torch.cuda.synchronize()
    assert fast_score_nms.launches == before + 1
    assert torch.equal(got, fast_score_nms_plain(img))


def test_fast_kernel_rejects_bad_input(cuda_device):  # noqa: F811
    with pytest.raises(ValueError):
        fast_score_nms(torch.zeros((32, 32), dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        fast_score_nms(torch.zeros((32, 64), device=cuda_device)[:, ::2])


@pytest.mark.parametrize("shape,n", [((480, 640), 165), ((278, 370), 96), ((96, 128), 5)])
def test_patch_kernel_matches_plain(cuda_device, shape, n):  # noqa: F811
    rng = np.random.default_rng(7)
    img = _image(shape, seed=7)
    yx = np.stack([rng.integers(20, shape[0] - 20, n), rng.integers(20, shape[1] - 20, n)], -1).astype(np.int32)
    if shape == (96, 128):
        yx = BORDER_YX
    img_d = torch.from_numpy(img).to(cuda_device)
    yx_d = torch.from_numpy(yx).to(cuda_device)
    pattern = orb_pattern(cuda_device)
    before = orb_patch_features.launches
    ang_k, desc_k = orb_patch_features(img_d, yx_d, pattern)
    torch.cuda.synchronize()
    assert orb_patch_features.launches == before + 1
    ang_p, desc_p = orb_patch_features_plain(img_d, yx_d, pattern)
    inside = (yx[:, 0] >= 19) & (yx[:, 1] >= 19)  # (0, 0) rows: window clamped vs shifted
    assert torch.isfinite(ang_k).all()
    assert wrapped_angle_error(ang_k.cpu().numpy(), ang_p.cpu().numpy())[inside].max() < ANGLE_TOL
    bits_k = unpack_bits(desc_k.cpu()).numpy()[inside]
    bits_p = unpack_bits(desc_p.cpu()).numpy()[inside]
    assert (bits_k != bits_p).mean() < BIT_TOL


def _pyramid(device, n_levels):
    """The pyramid of a rendered 640x480 frame: 4 levels as the bench's, 8 as TUM1's."""
    img = torch.from_numpy(rendered_frame(640, 480, seed=2)).to(device)
    return build_pyramid(img, n_levels, 1.2)


@pytest.mark.parametrize("n_levels", [4, 8])
def test_fast_levels_kernel_bit_exact(cuda_device, n_levels):  # noqa: F811
    levels = _pyramid(cuda_device, n_levels)
    before = fast_score_nms.launches
    got = fast_score_nms_levels(levels)
    torch.cuda.synchronize()
    assert fast_score_nms.launches == before + 1
    for img, score in zip(levels, got):
        assert score.shape == img.shape and score.is_contiguous()
        assert torch.equal(score, fast_score_nms_plain(img))


def test_fast_levels_kernel_rejects_more_than_max_levels(cuda_device):  # noqa: F811
    levels = _pyramid(cuda_device, MAX_LEVELS + 1)
    with pytest.raises(ValueError):
        fast_score_nms_levels(levels)


@pytest.mark.parametrize("n_features", [512, 800, 1600])
def test_patch_levels_kernel_matches_plain(cuda_device, n_features):  # noqa: F811
    """The keypoints of the bench's 4 levels, each level's first 4 rows moved
    to its 19 px border and its last row to (0, 0), as padding rows are."""
    levels = _pyramid(cuda_device, 4)
    yxs = []
    for img, budget in zip(levels, level_budgets(n_features, 4, 1.2)):
        yx = select_keypoints(fast_score_nms_plain(img), budget)[0].clone()
        h, w = img.shape
        yx[:4] = torch.tensor([[19, 19], [h - 20, w - 20], [19, w - 20], [h - 20, 19]], dtype=torch.int32)
        yx[-1] = 0
        yxs.append(yx)
    yx = torch.cat(yxs)
    start = np.concatenate([[0], np.cumsum([len(y) for y in yxs])]).tolist()
    pattern = orb_pattern(cuda_device)
    before = orb_patch_features.launches
    ang_k, desc_k, pm1_k = orb_patch_features_levels(levels, yx, start, pattern)
    torch.cuda.synchronize()
    assert orb_patch_features.launches == before + 1
    ang_p, desc_p, _ = orb_patch_features_levels_plain(levels, yx, start, pattern)
    assert torch.equal(pm1_k, unpack_to_pm1(desc_k))
    inside = (yx[:, 0] >= 19).cpu().numpy()  # (0, 0) rows: window clamped vs shifted
    assert torch.isfinite(ang_k).all()
    assert wrapped_angle_error(ang_k.cpu().numpy(), ang_p.cpu().numpy())[inside].max() < ANGLE_TOL
    bits_k = unpack_bits(desc_k.cpu()).numpy()[inside]
    bits_p = unpack_bits(desc_p.cpu()).numpy()[inside]
    assert (bits_k != bits_p).mean() < BIT_TOL


def test_patch_levels_kernel_rejects_more_than_max_levels(cuda_device):  # noqa: F811
    levels = _pyramid(cuda_device, MAX_LEVELS + 1)
    yx = torch.full((len(levels), 2), 20, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        orb_patch_features_levels(levels, yx, list(range(len(levels) + 1)), orb_pattern(cuda_device))


def test_patch_kernel_rejects_bad_input(cuda_device):  # noqa: F811
    img = torch.zeros((64, 64), device=cuda_device)
    pattern = orb_pattern(cuda_device)
    with pytest.raises(ValueError):
        orb_patch_features(img, torch.zeros((4, 2), dtype=torch.int64, device=cuda_device), pattern)
    with pytest.raises(ValueError):
        orb_patch_features(img, torch.zeros((4, 2), dtype=torch.int32), pattern)


def test_extractor_kernels_match_plain(cuda_device):  # noqa: F811
    cam = load_config("configs/TUM1.yaml").cam._replace(width=320, height=240)
    img = torch.from_numpy(rendered_frame(320, 240, dist=cam.dist)).to(cuda_device)
    before = fast_score_nms.launches, orb_patch_features.launches
    with torch.no_grad():
        fk = ORBExtractor(256, 1.2, 3, cam=cam).to(cuda_device)(img)
        fp = ORBExtractor(256, 1.2, 3, cam=cam, use_kernels=False).to(cuda_device)(img)
    # one launch of each kernel per extraction, over all 3 levels
    assert (fast_score_nms.launches, orb_patch_features.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(fk.desc_pm1, unpack_to_pm1(fk.desc_packed))
    # kernel A is bit-exact, so both paths select the same keypoints
    assert torch.equal(fk.valid, fp.valid)
    assert torch.equal(fk.xy_raw, fp.xy_raw)
    assert torch.equal(fk.response, fp.response)
    assert wrapped_angle_error(fk.angle.cpu().numpy(), fp.angle.cpu().numpy()).max() < ANGLE_TOL


def test_fused_step_kernels_match_plain(cuda_device):  # noqa: F811
    cfg = SlamConfig(**SMALL)
    step, args, _, _ = build_bench_state(cfg, n_images=1, device=cuda_device, n_points=400)
    plain = FusedSteadyStep(cfg, use_kernels=False).to(cuda_device)
    with torch.no_grad():
        got, want = step(*args), plain(*args)
    assert bool(got[5]) and bool(want[5])
    assert (got[1] - want[1]).abs().max().item() < 1e-3


@pytest.mark.parametrize("n_cams", [2, 70])
def test_bundle_adjustment_card_matches_cpu(cuda_device, n_cams):  # noqa: F811
    """The dense (2 cameras) and chunked (70 cameras) Schur paths; on the
    card twice."""
    rng = np.random.default_rng(n_cams)
    n_pts = 200
    pts = np.stack([rng.uniform(-1, 0.3 * n_cams, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 8, n_pts)], -1)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    poses[:, 0, 3] = -0.3 * np.arange(n_cams)
    obs_cam, obs_point, obs_uv = [], [], []
    for c in range(n_cams):
        pc = pts + poses[c, :3, 3]
        uv = pc[:, :2] / pc[:, 2:3] * 500.0 + [320.0, 240.0]
        seen = np.nonzero((np.abs(uv[:, 0] - 320) < 320) & (np.abs(uv[:, 1] - 240) < 240))[0]
        obs_cam += [c] * len(seen)
        obs_point += list(seen)
        obs_uv.append(uv[seen] + rng.normal(size=(len(seen), 2)) * 0.5)
    obs_point = np.asarray(obs_point)
    start = poses.copy()
    start[1:, :3, 3] += rng.normal(size=(n_cams - 1, 3)) * 0.01
    fields = dict(
        poses=start, points=(pts + rng.normal(size=pts.shape) * 0.05).astype(np.float32),
        obs_cam=np.asarray(obs_cam), obs_point=obs_point, obs_uv=np.concatenate(obs_uv).astype(np.float32),
        obs_inv_sigma2=np.ones(len(obs_point), np.float32), obs_mask=np.ones(len(obs_point), bool),
        point_obs=build_point_obs(obs_point, n_pts, int(np.bincount(obs_point).max())).astype(np.int64),
        fixed_cam=np.arange(n_cams) < min(2, n_cams - 1),
        K=np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32),
    )
    outs = []
    for device in ("cpu", cuda_device, cuda_device):
        prob = BAProblem(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in fields.items()})
        outs.append([t.cpu().numpy() for t in bundle_adjustment(prob, iterations=3)])
    (P_c, X_c, _), (P_g, X_g, _), again = outs
    assert all(np.array_equal(a, b) for a, b in zip(again, outs[1]))
    assert np.abs(P_g - P_c).max() < 1e-3
    assert np.all(np.abs(X_g - X_c) < 1e-3 * pts[:, 2:3])


def test_system_on_card(cuda_device):  # noqa: F811
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=16, n_points=700, kind="strafe", seed=3)
    cfg = SlamConfig(n_features=600, n_levels=4, fps=10.0, k_max=64, l_max=8192, enable_loop_closing=False)
    system = SlamSystem(cfg, device=cuda_device)
    calls = []
    for extractor in (system.tracker.extractor, system.tracker.ini_extractor):
        extractor.register_forward_hook(lambda *_: calls.append(1))
    before = fast_score_nms.launches, orb_patch_features.launches
    with torch.no_grad():
        for i in range(seq.n_frames):
            system.track_monocular(seq.render(i), 0.1 * i)
    assert system.state == TrackingState.OK and system.map.n_kf_active() >= 3
    # one launch of each kernel per extraction
    assert fast_score_nms.launches - before[0] == len(calls) == orb_patch_features.launches - before[1]
    assert len(calls) >= seq.n_frames
    assert system.tracker.n_fused_frames > 0
    m = system.map
    for name in ("lm_pos", "lm_valid", "lm_desc_pm1", "lm_normal", "lm_min_dist", "lm_max_dist", "lm_octave",
                 "kf_pose", "kf_xy", "kf_octave", "kf_angle", "kf_feat_valid", "kf_desc_pm1"):
        assert getattr(m, name).is_cuda and np.array_equal(getattr(m, name).cpu().numpy(), m.hview(name)), name


def test_system_api_on_card(cuda_device):  # noqa: F811
    from orbslam_in_practice_tpu_torch import regimes

    seq, cfg, _ = regimes.build("distortion")
    system = SlamSystem(cfg, "vocab.txt")  # the device defaults to the card
    tracker = system.tracker
    assert tracker.device.type == "cuda" and system.map.kf_pose.is_cuda and tracker.cam == cfg.cam
    with torch.no_grad():
        for i in range(8):
            system.Trackmonocular(seq.render(i), 0.1 * i)
    assert system.state == TrackingState.OK and tracker.frame_path == "fused"
    frame = tracker.last_frame
    assert frame.xy.is_cuda and frame.xy_raw.is_cuda and frame.valid.is_cuda
    assert float((frame.xy - frame.xy_raw).abs()[frame.valid].max()) > 1.0
    # the two initial keyframes, then one a local-mapping epoch
    assert tracker.new_kf_ids[:2] == [0, 1] and len(tracker.new_kf_ids) == tracker.mapper.n_epochs + 2


def test_pose_graph_card_matches_cpu(cuda_device):  # noqa: F811
    """tests/test_sim3_lie.py's drifted chain: a line of 10 poses, odometry
    edges from the drifted estimate, one loop edge from the truth."""
    n = 10
    true_xi = torch.zeros((n, 7))
    true_xi[:, 0] = torch.arange(n) * 0.5
    drift = torch.zeros((n, 7))
    drift[:, 1] = torch.arange(n) * 0.05
    drift[:, 6] = torch.arange(n) * 0.01
    S_true, S_est = exp_sim3(true_xi), exp_sim3(true_xi + drift)
    ei = torch.tensor(list(range(n - 1)) + [0])
    ej = torch.tensor(list(range(1, n)) + [n - 1])
    meas = torch.cat([S_est[1:] @ torch.linalg.inv(S_est[:-1]), (S_true[-1] @ torch.linalg.inv(S_true[0]))[None]])
    w = torch.tensor([1.0] * (n - 1) + [10.0])
    fixed = torch.arange(n) == 0
    args = (S_est, ei, ej, meas, w, fixed)
    cpu = optimize_pose_graph(*args)
    card = optimize_pose_graph(*(a.to(cuda_device) for a in args))
    assert card.is_cuda and (card.cpu() - cpu).abs().max().item() < 1e-3
    assert (cpu[-1] - S_true[-1]).norm() < 0.1 * (S_est[-1] - S_true[-1]).norm()


def test_pose_graph_card_is_deterministic(cuda_device):  # noqa: F811
    """A loop closure's essential graph at the orbit's size (48 keyframes,
    each joined to its next three and a few loop edges, noisy measurements):
    three runs on the card give the same bits."""
    gen = torch.Generator().manual_seed(0)
    n = 48
    xi = torch.zeros((n, 7))
    xi[:, 3] = torch.arange(n) * 0.13  # yaw around an orbit
    xi[:, 0] = torch.arange(n) * 0.4
    S = exp_sim3(xi)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, min(i + 4, n))] + [(0, n - 1), (1, n - 2), (2, n - 1)]
    ei = torch.tensor([i for i, _ in pairs])
    ej = torch.tensor([j for _, j in pairs])
    noise = exp_sim3(0.01 * torch.randn((len(pairs), 7), generator=gen))
    meas = noise @ S[ej] @ torch.linalg.inv(S[ei])
    S_est = exp_sim3(xi + 0.05 * torch.randn((n, 7), generator=gen))
    args = [a.to(cuda_device) for a in (S_est, ei, ej, meas, torch.ones(len(pairs)), torch.arange(n) == 0)]
    runs = [optimize_pose_graph(*args).cpu() for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    assert torch.isfinite(runs[0]).all()


def _reloc_scene(device):
    """An aliased keyframe whose landmarks are garbage, ranked first, then
    the true one (tests/test_relocalization.py's first scenario), and the
    query frame seen from a slightly moved pose."""
    rng = np.random.default_rng(0)
    n_feat, n_lm = 64, 48
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
    X = np.stack([rng.uniform(-2, 2, n_lm), rng.uniform(-1.5, 1.5, n_lm), rng.uniform(4, 9, n_lm)], -1).astype(np.float32)
    desc = np.where(rng.uniform(size=(n_feat, 256)) > 0.5, 1, -1).astype(np.int8)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.2, -0.1, 0.3]

    def project(T_, X_):
        pc = X_ @ T_[:3, :3].T + T_[:3, 3]
        return (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]

    def frame(T_, valid):
        xy = np.zeros((n_feat, 2), np.float32)
        xy[:n_lm] = project(T_, X)
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return Frame(xy=t(xy), xy_raw=t(xy), octave=t(np.zeros(n_feat, np.int32)), angle=t(np.zeros(n_feat, np.float32)),
                     response=t(np.ones(n_feat, np.float32)), valid=t(valid),
                     desc_packed=t(np.zeros((n_feat, 8), np.int32)), desc_pm1=t(desc))

    valid = np.arange(n_feat) < n_lm
    smap = SlamMap(k_max=8, l_max=256, f_max=n_feat, device=device)
    obs_a = np.where(valid, np.arange(n_feat), -1).astype(np.int32)
    kf_a = smap.add_keyframe(frame(T, valid), T, obs_a, 0)
    valid_b = np.arange(n_feat) < 40
    obs_b = np.where(valid_b, n_lm + np.arange(n_feat), -1).astype(np.int32)
    kf_b = smap.add_keyframe(frame(T, valid_b), T, obs_b, 1)
    zeros = np.zeros((n_lm, 3), np.float32)
    for ids, pos, first in ((np.arange(n_lm), X[rng.permutation(n_lm)] + rng.normal(size=(n_lm, 3)) * 2.0, kf_a),
                            (n_lm + np.arange(40), X[:40], kf_b)):
        m = len(ids)
        smap.add_landmarks(ids.astype(np.int32), pos, desc[:m], zeros[:m], np.zeros(m, np.int32),
                           np.zeros(m, np.float32), np.full(m, np.inf, np.float32), first_kf=first)
    T_q = T.copy()
    T_q[:3, 3] += [0.05, 0.02, -0.04]

    tracker = SimpleNamespace(map=smap, K=torch.from_numpy(K).to(device), cfg=SimpleNamespace(n_levels=4),
                              inv_level_sigma2=torch.ones(4, device=device))
    return tracker, frame(T_q, valid), kf_b, T_q


def test_relocalize_card_matches_cpu(cuda_device):  # noqa: F811
    rng = np.random.default_rng(1)
    idx = {ci: torch.from_numpy(rng.integers(0, 40, (64, 6))) for ci in range(8)}
    outs = []
    for device in ("cpu", cuda_device):
        tracker, frame, kf_b, T_q = _reloc_scene(device)
        outs.append(relocalize(tracker, frame, sample_idx=idx))
    (ok_c, T_c, obs_c, n_c, kf_c), (ok_g, T_g, obs_g, n_g, kf_g) = outs
    assert ok_c and ok_g and kf_c == kf_g == kf_b and n_c == n_g >= 10
    assert np.array_equal(obs_c, obs_g)
    assert np.abs(T_g - T_c).max() < 1e-3 and np.abs(T_g - T_q).max() < 0.02


def test_sim3_ransac_card_matches_cpu(cuda_device):  # noqa: F811
    """tests/test_loop_closing.py's Sim3 RANSAC problem: 128 pairs, 20 outliers."""
    rng = np.random.default_rng(0)
    n = 128
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], np.float32)
    pa = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 9, n)], -1).astype(np.float32)
    R = exp_so3(torch.tensor([0.05, 0.2, -0.1])).numpy()
    pb = (1.3 * pa @ R.T + np.array([0.5, -0.2, 0.8], np.float32)).astype(np.float32)
    pb[:20] += rng.uniform(1, 3, (20, 3)).astype(np.float32)

    def project(p):
        return (p[:, :2] / p[:, 2:3] * 400.0 + [320.0, 240.0]).astype(np.float32)

    ones = np.ones(n, np.float32)
    args = (pa, pb, project(pa), project(pb), ones, ones, np.ones(n, bool), K)
    idx = torch.from_numpy(rng.integers(0, n, (N_HYP, 3)))
    outs = []
    for device in ("cpu", cuda_device):
        res = sim3_ransac(*(torch.from_numpy(a).to(device) for a in args), sample_idx=idx)
        outs.append([r.cpu() for r in res])
    (s_c, R_c, t_c, inl_c, n_c), (s_g, R_g, t_g, inl_g, n_g) = outs
    assert int(n_c) == int(n_g) >= 100 and torch.equal(inl_c, inl_g)
    assert abs(float(s_g) - float(s_c)) < 1e-3 and abs(float(s_c) - 1.3) < 0.02
    assert (R_g - R_c).abs().max() < 1e-3 and (t_g - t_c).abs().max() < 1e-3


def test_async_system_on_card(cuda_device):  # noqa: F811
    """Asynchronous mapping on the card, the device given without an index:
    tracker and worker queue on the default stream; after the drain
    the state is OK, every queued epoch ran, the map's device tables equal
    its host truth, the kernels launched once per extraction (the worker
    extracts nothing) and shutdown joins the worker."""
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=16, n_points=700, kind="strafe", seed=3)
    cfg = SlamConfig(n_features=600, n_levels=4, fps=10.0, k_max=64, l_max=8192, async_mapping=True)
    system = SlamSystem(cfg, device="cuda")  # no index, as run_slam passes it
    drv = system.tracker.async_driver
    calls, streams = [], set()
    for extractor in (system.tracker.extractor, system.tracker.ini_extractor):
        extractor.register_forward_hook(lambda *_: calls.append(1))
    epoch = system.tracker.mapper.process_new_keyframe

    def on_worker(*args):
        streams.add(torch.cuda.current_stream().cuda_stream)
        return epoch(*args)

    system.tracker.mapper.process_new_keyframe = on_worker
    before = fast_score_nms.launches, orb_patch_features.launches
    with torch.no_grad():
        for i in range(seq.n_frames):
            system.track_monocular(seq.render(i), 0.1 * i)
            assert drv.pending() <= drv.QUEUE_MAX
    assert system.wait_idle(timeout=120.0)
    assert system.state == TrackingState.OK and drv.n_processed >= 1
    assert streams == {torch.cuda.default_stream().cuda_stream}
    assert fast_score_nms.launches - before[0] == len(calls) == orb_patch_features.launches - before[1]
    m = system.map
    for name in ("lm_pos", "lm_valid", "lm_desc_pm1", "lm_normal", "kf_pose", "kf_feat_valid", "kf_desc_pm1"):
        assert np.array_equal(getattr(m, name).cpu().numpy(), m.hview(name)), name
    system.shutdown()
    assert not drv.is_alive()


def test_dist_ba_one_rank_nccl_matches_cpu(cuda_device):  # noqa: F811
    """dist_bundle_adjustment in a one-rank NCCL group (a TCPStore on
    127.0.0.1), 8 local shards, against the same call on CPU tensors without
    a group: poses and points within 1e-4."""
    import socket

    import torch.distributed as dist

    from orbslam_in_practice_tpu_torch.parallel.dist_ba_worker import run

    want = run(8, "cpu", 10)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(cuda_device)
    store = dist.TCPStore("127.0.0.1", port, 1, True)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0)
    try:
        got = run(8, cuda_device, 10)
    finally:
        dist.destroy_process_group()
    assert np.abs(got[0] - want[0]).max() < 1e-4
    assert np.abs(got[1] - want[1]).max() < 1e-4
