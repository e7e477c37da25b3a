"""Parity of the port's host-side and geometry modules with the JAX
package: configuration parsing, camera undistortion, the SE(3) exponential,
logarithm, inverse and point transform, and the synthetic renderer."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu.config import load_config as jax_load_config
from orbslam_in_practice_tpu.geometry import camera as jcam
from orbslam_in_practice_tpu.geometry import se3 as jse3
from orbslam_in_practice_tpu.io.synthetic import SyntheticSequence as JaxSequence
from orbslam_in_practice_tpu.ops.orb import level_budgets as jax_level_budgets
from orbslam_in_practice_tpu_torch.config import load_config
from orbslam_in_practice_tpu_torch.geometry import camera as tcam
from orbslam_in_practice_tpu_torch.geometry import se3 as tse3
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch.ops.orb import level_budgets

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["TUM1.yaml", "KITTI00-02.yaml", "EuRoC.yaml"])
def test_config_parses_like_jax(name):
    want = jax_load_config(f"configs/{name}")
    got = load_config(f"configs/{name}")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert np.array_equal(got.cam.K().numpy(), np.asarray(want.cam.K))
    assert got.cam.has_distortion == want.cam.has_distortion


def test_level_budgets_match():
    for args in [(512, 4, 1.2), (1000, 8, 1.2), (256, 3, 1.2), (1024, 4, 1.2)]:
        assert level_budgets(*args) == jax_level_budgets(*args)
    assert level_budgets(512, 4, 1.2) == [165, 137, 114, 96]


def test_undistort_points_matches_jax():
    cfg = load_config("configs/TUM1.yaml")
    uv = np.random.default_rng(0).uniform([0, 0], [640, 480], size=(200, 2)).astype(np.float32)
    K = cfg.cam.K().numpy()
    dist = np.asarray(cfg.cam.dist, np.float32)
    want = np.asarray(jcam.undistort_points(jnp.asarray(K), jnp.asarray(dist), jnp.asarray(uv)))
    got = tcam.undistort_points(torch.from_numpy(K), torch.from_numpy(dist), torch.from_numpy(uv))
    assert np.abs(got.numpy() - want).max() < 1e-3


def test_exp_se3_matches_jax():
    xi = np.random.default_rng(1).normal(scale=[0.5, 0.5, 0.5, 0.3, 0.3, 0.3], size=(64, 6))
    xi[:4, 3:] = 0.0  # the small-angle series branch
    xi = xi.astype(np.float32)
    want = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    got = tse3.exp_se3(torch.from_numpy(xi)).numpy()
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(tse3.hat(torch.from_numpy(xi[:, :3])).numpy() - np.asarray(jse3.hat(jnp.asarray(xi[:, :3])))).max() == 0


def test_se3_log_inverse_transform_match_jax():
    """log_so3 (generic, small-angle and near-pi branches), log_se3,
    se3_inverse and transform_points (one pose and batched poses) against
    the JAX package, float32, within 1e-5."""
    rng = np.random.default_rng(2)
    axis = rng.uniform(0.3, 1.0, size=(48, 3)) * rng.choice([-1.0, 1.0], size=(48, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.01, 3.0, size=48)
    angle[:4] = 1e-5  # series branch
    angle[4:8] = np.pi - 5e-4  # diagonal-extraction branch
    xi = np.concatenate([rng.normal(size=(48, 3)), axis * angle[:, None]], axis=1).astype(np.float32)
    T = np.array(jse3.exp_se3(jnp.asarray(xi)))
    Tt = torch.from_numpy(T)
    for name in ("log_se3", "se3_inverse"):
        want = np.asarray(getattr(jse3, name)(jnp.asarray(T)))
        assert np.abs(getattr(tse3, name)(Tt).numpy() - want).max() < 1e-5, name
    want = np.asarray(jse3.log_so3(jnp.asarray(T[:, :3, :3])))
    assert np.abs(tse3.log_so3(Tt[:, :3, :3]).numpy() - want).max() < 1e-5
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    for poses in (T[9], T[9:12]):
        want = np.asarray(jse3.transform_points(jnp.asarray(poses), jnp.asarray(pts)))
        got = tse3.transform_points(torch.from_numpy(poses), torch.from_numpy(pts)).numpy()
        assert got.shape == want.shape and np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("kind", ["strafe", "rotation"])
def test_synthetic_sequence_matches_jax(kind):
    kw = dict(n_frames=3, n_points=200, width=160, height=120, kind=kind, seed=4)
    want, got = JaxSequence(**kw), SyntheticSequence(**kw)
    assert np.abs(got.poses - want.poses).max() < 1e-6
    img_w, img_g = want.render(2), got.render(2)
    assert np.abs(img_g - img_w).max() < 1e-2
    xy = np.random.default_rng(5).uniform([0, 0], [160, 120], size=(50, 2)).astype(np.float32)
    (X_w, v_w), (X_g, v_g) = want.backproject(1, xy), got.backproject(1, xy)
    assert np.array_equal(v_g, v_w)
    assert np.abs(X_g - X_w)[v_w].max() < 1e-4


K_CAM = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
DIST_TUM = np.array([-0.28, 0.07, 1e-4, -2e-5, 0.0], np.float32)  # tests/test_camera.py's


def test_project_and_distort_match_jax():
    """tests/test_camera.py's cases: project / unproject round trip, and
    undistort_points inverting distort_radtan; both within 1e-5 of the JAX
    package (pixels: 1e-3)."""
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-1.5, 1.5, 50), rng.uniform(2, 9, 50)], -1).astype(np.float32)
    uv = tcam.project(torch.from_numpy(K_CAM), torch.from_numpy(pts)).numpy()
    assert np.abs(uv - np.asarray(jcam.project(jnp.asarray(K_CAM), jnp.asarray(pts)))).max() < 1e-3
    xy = tcam.unproject(torch.from_numpy(K_CAM), torch.from_numpy(uv)).numpy()
    assert np.allclose(xy, pts[:, :2] / pts[:, 2:3], atol=1e-5)
    xy = rng.uniform(-0.4, 0.4, size=(100, 2)).astype(np.float32)
    xyd = tcam.distort_radtan(torch.from_numpy(xy), torch.from_numpy(DIST_TUM)).numpy()
    assert np.abs(xyd - np.asarray(jcam.distort_radtan(jnp.asarray(xy), jnp.asarray(DIST_TUM)))).max() < 1e-5
    uv_d = xyd * np.diag(K_CAM)[:2] + K_CAM[:2, 2]
    uv_u = tcam.undistort_points(torch.from_numpy(K_CAM), torch.from_numpy(DIST_TUM), torch.from_numpy(uv_d)).numpy()
    assert np.abs(uv_u - (xy * np.diag(K_CAM)[:2] + K_CAM[:2, 2])).max() < 0.05


@pytest.mark.parametrize("dist", [(0.0, 0.0, 0.0, 0.0, 0.0), (-0.28, 0.07, 1e-4, -2e-5, 0.0)])
def test_image_bounds_match_jax(dist):
    args = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, dist=dist, width=640, height=480)
    got = tcam.compute_image_bounds(tcam.CameraIntrinsics(**args))
    want = jcam.compute_image_bounds(jcam.CameraIntrinsics(**args))
    assert np.allclose(got, want, atol=1e-3)
    if any(dist):  # barrel distortion: the undistorted corners lie outside the image
        assert got[0] < 0 and got[1] > 640 and got[2] < 0 and got[3] > 480
    else:
        assert got == (0.0, 640.0, 0.0, 480.0)


def test_compose_and_rot_to_quat_match_jax():
    """se3_compose and rot_to_quat, batched, on random rotations and the
    branch cases (identity, turns of pi about each axis): quaternions within
    1e-6 of the JAX package, w >= 0, and back to the same rotation."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 3)).astype(np.float32) * 1.5
    w = np.concatenate([w, np.zeros((1, 3)), np.pi * np.eye(3) * 0.9999]).astype(np.float32)
    R = tse3.exp_so3(torch.from_numpy(w))
    got = tse3.rot_to_quat(R).numpy()
    want = np.asarray(jse3.rot_to_quat(jnp.asarray(R.numpy())))
    assert np.abs(got - want).max() < 1e-6 and (got[:, 0] >= 0).all()
    assert np.abs(tse3.quat_to_rot(torch.from_numpy(got)).numpy() - R.numpy()).max() < 1e-5
    xi = torch.from_numpy(rng.normal(size=(2, 8, 6)).astype(np.float32) * 0.3)
    A, B = tse3.exp_se3(xi[0]), tse3.exp_se3(xi[1])
    want = np.asarray(jse3.se3_compose(jnp.asarray(A.numpy()), jnp.asarray(B.numpy())))
    assert np.abs(tse3.se3_compose(A, B).numpy() - want).max() < 1e-6


def test_frame_num_valid_matches_jax():
    from orbslam_in_practice_tpu.frontend.orb import ORBExtractor as JaxExtractor
    from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor

    img = np.random.default_rng(6).uniform(0, 255, (96, 128)).astype(np.float32)
    want = JaxExtractor(64, 1.2, 2, 20.0, 7.0)(jnp.asarray(img))
    got = ORBExtractor(64, 1.2, 2, 20.0, 7.0)(torch.from_numpy(img))
    assert int(got.num_valid()) == int(want.num_valid()) == int(got.valid.sum()) > 0
