"""The benchmark's scene: the frozen copy against the port's renderer, the
renderer on a torch device against the copy, and the mixes' speeds."""

import json

import numpy as np
import pytest
import torch

from portbench.scene import SyntheticSequence, TorchRenderer, make_trajectory
from portbench.traffic import build_sequence

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]


def _settings(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())["settings"]


def _mix(name):
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("regime", ["strafe", "distortion", "kitti_res"])
def test_copy_matches_the_port_on_its_own_parameters(regime):
    from orbslam_in_practice_tpu_torch.regimes import build

    port, _, _ = build(regime)
    kw = dict(n_frames=port.n_frames, n_points=len(port.pts), width=port.width, height=port.height,
              fx=float(port.K[0, 0]), fy=float(port.K[1, 1]), seed=port.seed, noise_sigma=port.noise_sigma,
              brightness_jitter=port.brightness_jitter, dist=port.dist)
    if regime == "kitti_res":
        kw.update(depth_range=(5.0, 20.0), spread=(10.0, 4.0), size_range=(0.2, 1.0))
    copy = SyntheticSequence(kind="strafe", **kw)
    copy.poses = port.poses if regime == "kitti_res" else copy.poses
    np.testing.assert_allclose(copy.poses, port.poses, atol=1e-6)
    np.testing.assert_array_equal(copy.pts, port.pts)
    for i in (0, port.n_frames - 1):
        a, b = copy.render(i), port.render(i)
        assert np.mean(np.abs(a - b) > 1e-2) < 1e-3
        assert np.mean(np.abs(a - b)) < 1e-3


def test_corridor_copy_matches_the_port():
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence as PortSeq

    kw = dict(n_frames=60, n_points=1200, width=1241, height=376, fx=718.0, fy=718.0, kind="kitti_loop", step=0.35,
              seed=3, depth_range=(5.0, 20.0), spread=(10.0, 3.0), size_range=(0.3, 1.2), noise_sigma=4.0,
              brightness_jitter=0.15)
    copy, port = SyntheticSequence(**kw), PortSeq(**kw)
    np.testing.assert_allclose(copy.poses, port.poses, atol=1e-6)
    np.testing.assert_allclose(copy.pts, port.pts, atol=1e-5)
    a, b = copy.render(30), port.render(30)
    assert np.mean(np.abs(a - b) > 1e-2) < 1e-3


@pytest.mark.parametrize("cell", [("tum1", "xyz", 3), ("kitti00", "drive", 97)])
def test_torch_renderer_matches_the_copy(cell):
    config, mix, frame = cell
    m = dict(_mix(mix), session_frames=120)
    seq = build_sequence(m, _settings(config), 2**31 + 17)
    a, b = seq.render(frame), TorchRenderer(seq, "cpu").render(frame)
    d = np.abs(a - b)
    assert d.max() < 1.0  # an edge pixel may take the neighbouring quad's value blurred
    assert np.mean(d > 1e-2) < 1e-3


def test_the_principal_point_is_the_configurations():
    s = _settings("tum1")
    seq = build_sequence(dict(_mix("xyz"), session_frames=10), s, 1)
    assert seq.K[0, 2] == np.float32(s["cx"]) and seq.K[1, 2] == np.float32(s["cy"])


def _speeds(poses):
    c = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses]).astype(np.float64)
    trans = np.linalg.norm(np.diff(c, axis=0), axis=-1)
    rot = [np.degrees(np.arccos(np.clip((np.trace(poses[k][:3, :3].astype(np.float64) @ poses[k + 1][:3, :3].T
                                                   .astype(np.float64)) - 1) / 2, -1, 1)))
           for k in range(len(poses) - 1)]
    return trans.mean(), float(np.mean(rot))


def test_xyz_hover_has_fr1_xyz_published_speeds():
    s, m = _settings("tum1"), _mix("xyz")
    seq = build_sequence(m, s, 5)
    trans, rot = _speeds(seq.poses)
    assert trans == pytest.approx(0.244 / 30.0, rel=1e-3)  # 8.13 mm a frame
    assert rot == pytest.approx(8.92 / 30.0, rel=1e-2)  # 0.297 deg a frame
    c = seq.gt_centers()
    # along x, then y, then z, in turn
    for axis in range(3):
        seg = c[axis * 100 : (axis + 1) * 100]
        assert np.ptp(seg[:, axis]) > 5 * max(np.ptp(seg[:, k]) for k in range(3) if k != axis)


def test_drive_moves_0_12_m_a_frame_through_a_90_degree_turn():
    seq = build_sequence(_mix("drive"), _settings("kitti00"), 5)
    trans, _ = _speeds(seq.poses)
    assert trans == pytest.approx(0.12, rel=0.05)  # the sway adds a little
    R0, R1 = seq.poses[0][:3, :3], seq.poses[130][:3, :3]
    assert np.degrees(np.arccos((np.trace(R0 @ R1.T) - 1) / 2)) == pytest.approx(90.0, abs=1.0)
    np.testing.assert_allclose(seq.poses, make_trajectory(200, "kitti_loop", step=0.12), atol=0)


def test_the_world_is_the_mixs_and_the_noise_the_seeds():
    m, s = dict(_mix("xyz"), session_frames=20), _settings("tum1")
    a, b = build_sequence(m, s, 1), build_sequence(m, s, 2)
    np.testing.assert_array_equal(a.pts, b.pts)
    assert not np.array_equal(a.render(3), b.render(3))
    np.testing.assert_array_equal(a.render(3), build_sequence(m, s, 1).render(3))
