"""The port's distributed BA (``parallel/``) against the JAX package's on
tests/test_dist_ba.py's problems, on the CPU: one rank without a process
group holding all 8 landmark shards, against the JAX package's 8-device
virtual mesh (tests/conftest.py).

- ``partition_ba_problem`` equals the JAX package's array for array,
  exactly;
- ``dist_bundle_adjustment`` on make_problem (15 LM iterations): poses
  within 1e-5 and points within 1e-4 of the JAX result, and the JAX test's
  gates against the truth (5e-3, 3e-2);
- ``distributed_global_ba`` on the same map in both packages: the same
  counts, poses within 1e-5, landmarks within 1e-4;
- ``run_batch`` runs a synthetic sequence and its distributed global BA.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from test_dist_ba import K, make_problem
from torch_parity import map_to_torch

from orbslam_in_practice_tpu.parallel import dist_ba as jdist
from orbslam_in_practice_tpu.slam.map import SlamMap as JaxMap
from orbslam_in_practice_tpu_torch import run_batch
from orbslam_in_practice_tpu_torch.parallel import dist_ba
from orbslam_in_practice_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

POSE_TOL, POINT_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def jax_mesh():
    devs = np.array(jax.devices()[:8])
    assert len(devs) == 8
    return JaxMesh(devs, ("d",))


def _perturbed(seed=0):
    rng = np.random.default_rng(seed)
    poses_true, pts, obs_cam, obs_point, obs_uv = make_problem(rng)
    n_cams = len(poses_true)
    poses0 = poses_true.copy()
    xi = rng.normal(size=(n_cams - 2, 6)).astype(np.float32) * 0.03
    from orbslam_in_practice_tpu_torch.geometry.se3 import exp_se3

    poses0[2:] = exp_se3(torch.from_numpy(xi)).numpy() @ poses0[2:]
    pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.08
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    args = (poses0, pts0, obs_cam, obs_point, obs_uv, np.ones(len(obs_cam), np.float32), fixed, K)
    return args, poses_true, pts


def test_partition_equals_jax():
    args, _, _ = _perturbed()
    want = jdist.partition_ba_problem(*args, n_shards=8)
    got = dist_ba.partition_ba_problem(*args, n_shards=8)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_dist_ba_matches_jax(jax_mesh):
    args, poses_true, pts = _perturbed()
    jpose, jpts = jdist.dist_bundle_adjustment(jdist.partition_ba_problem(*args, n_shards=8), jax_mesh, iterations=15)
    mesh = make_mesh(8, "cpu")
    assert (mesh.world_size, mesh.local_shards, mesh.distributed) == (1, 8, False)
    poses, points = dist_ba.dist_bundle_adjustment(dist_ba.partition_ba_problem(*args, n_shards=8), mesh, iterations=15)
    poses, points = poses.numpy(), points.numpy()
    assert np.abs(poses - np.asarray(jpose)).max() < POSE_TOL
    assert np.abs(points - np.asarray(jpts)).max() < POINT_TOL
    assert np.allclose(poses, poses_true, atol=5e-3)
    assert np.allclose(points[: len(pts)], pts, atol=3e-2)


def _jax_map(seed=0):
    """tests/test_dist_ba.py::test_distributed_global_ba_on_map's map:
    6 keyframes seeing 200 landmarks, perturbed but for the gauge."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    n_kf, n_lm, n_feat = 6, 200, 256
    smap = JaxMap(k_max=8, l_max=512, f_max=n_feat)
    pts = np.stack(
        [rng.uniform(-4, 4, n_lm), rng.uniform(-3, 3, n_lm), rng.uniform(5, 12, n_lm)], axis=-1
    ).astype(np.float32)

    class F:
        n_features = n_feat

        def __init__(self, xy, valid):
            self.xy = jnp.asarray(xy)
            self.octave = jnp.zeros(n_feat, jnp.int32)
            self.angle = jnp.zeros(n_feat, jnp.float32)
            self.response = jnp.zeros(n_feat, jnp.float32)
            self.valid = jnp.asarray(valid)
            self.desc_pm1 = jnp.zeros((n_feat, 256), jnp.int8)

    smap.allocate_landmarks(n_lm)
    smap.lm_pos = smap.lm_pos.at[:n_lm].set(jnp.asarray(pts))
    smap.lm_valid = smap.lm_valid.at[:n_lm].set(True)
    poses_true = []
    for c in range(n_kf):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.25 * c, 0.0, 0.0]
        poses_true.append(T)
        pc = pts @ T[:3, :3].T + T[:3, 3]
        xy = np.zeros((n_feat, 2), np.float32)
        xy[:n_lm] = (pc[:, :2] / pc[:, 2:3]) * 500.0 + np.array([320.0, 240.0])
        valid = np.arange(n_feat) < n_lm
        obs = np.where(valid, np.arange(n_feat), -1).astype(np.int32)
        smap.add_keyframe(F(xy, valid), jnp.asarray(T), obs, c)
    for c in range(2, n_kf):
        T = np.asarray(smap.kf_pose[c]).copy()
        T[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.05
        smap.set_kf_poses([c], [T])
    smap.set_landmark_positions(np.arange(n_lm), pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05)
    return smap, np.stack(poses_true), pts


def test_distributed_global_ba_matches_jax(jax_mesh):
    jmap, poses_true, pts = _jax_map()
    tmap = map_to_torch(jmap)
    mesh = make_mesh(8, "cpu")
    cost0 = dist_ba.problem_cost(dist_ba.map_problem(tmap, K, np.ones(1, np.float32), 8)[0], mesh)
    want = jdist.distributed_global_ba(jmap, K, np.ones(1, np.float32), jax_mesh, iterations=15)
    got = dist_ba.distributed_global_ba(tmap, torch.from_numpy(K), np.ones(1, np.float32), mesh, iterations=15)
    assert got == tuple(int(v) for v in want) == (6, 200, 1200)
    n_lm = len(pts)
    assert np.abs(tmap.hview("kf_pose")[:6] - np.asarray(jmap.hview("kf_pose"))[:6]).max() < POSE_TOL
    assert np.abs(tmap.hview("lm_pos")[:n_lm] - np.asarray(jmap.hview("lm_pos"))[:n_lm]).max() < POINT_TOL
    assert np.allclose(tmap.hview("kf_pose")[:6], poses_true, atol=5e-3)
    assert np.array_equal(tmap.kf_pose.numpy(), tmap.hview("kf_pose"))
    cost1 = dist_ba.problem_cost(dist_ba.map_problem(tmap, K, np.ones(1, np.float32), 8)[0], mesh)
    assert cost1 < 1e-3 * cost0


def test_run_batch_cli(tmp_path, capsys):
    out = run_batch.main(["--synthetic", "1", "--frames", "12", "--mesh", "4", "--device", "cpu",
                          "--out-dir", str(tmp_path)])
    res = out["synthetic_0"]
    assert res["frames"] == 12 and res["gba"]["shards"] == 4 and res["gba"]["cams"] >= 3
    assert res["gba"]["cost_after"] <= res["gba"]["cost_before"]
    assert (tmp_path / "batch_syn0_traj.txt").exists() and (tmp_path / "batch_syn0_map.npz").exists()
    assert json.loads(capsys.readouterr().out)["synthetic_0"]["gba"]["points"] > 0


def test_worker_problem_is_the_jax_tests_problem():
    """dist_ba_worker.make_problem(seed=0, 6 cameras, 256 landmarks), which
    chip_smoke.py solves on the card, is tests/test_dist_ba.py's problem:
    the same arrays within 1e-6 (the port's exp_so3 / exp_se3 for the
    JAX package's)."""
    from orbslam_in_practice_tpu_torch.parallel.dist_ba_worker import make_problem as worker_problem

    (poses0, pts0, obs_cam, obs_point, obs_uv, _, fixed, _), poses_true, pts = _perturbed()
    p = worker_problem(seed=0, n_cams=6, n_pts=256)
    for name, want in (("poses0", poses0), ("points0", pts0), ("obs_cam", obs_cam), ("obs_point", obs_point),
                       ("obs_uv", obs_uv), ("fixed", fixed), ("poses", poses_true), ("points", pts), ("K", K)):
        got, want = np.asarray(p[name], np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max()), name
