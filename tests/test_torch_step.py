"""Parity of the port's tracking slice with the JAX package on one small
scene (320x240, 256 features, 3 levels, 2048 landmark slots): projection
matching and pose optimisation on the same JAX Frame, then the whole fused
steady-state step fed the same state through ``state_from_numpy``; last, 10
chained frames of the benchmark scene at full size.

Tolerances: matches are exact; poses from the same inputs agree within
1e-5 (float32 LM steps summed in another order); the whole step agrees in
its flags, within 3% in its inlier count and within 1e-3 in rotation (rad)
and translation, since its level >= 1 pyramid pixels may differ by 2 ulps.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, frame_to_torch

from orbslam_in_practice_tpu.config import SlamConfig as JaxConfig
from orbslam_in_practice_tpu.frontend.matcher import search_by_projection as jax_search
from orbslam_in_practice_tpu.frontend.orb import ORBExtractor as JaxExtractor
from orbslam_in_practice_tpu.optim.pose_opt import pose_optimization as jax_pose_opt
from orbslam_in_practice_tpu.slam.tracking import Tracking
from orbslam_in_practice_tpu_torch.bench_state import bench_arrays, bench_config, state_from_numpy
from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.frontend.matcher import search_by_projection
from orbslam_in_practice_tpu_torch.optim.pose_opt import pose_optimization
from orbslam_in_practice_tpu_torch.slam.tracking import LOCAL_MAP_MAX, FusedSteadyStep

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    """The small scene's step state (numpy), frames 1-2, and the JAX Frame
    of frame 1 with the inputs the step's stage 1 gives the matcher."""
    cfg = SlamConfig(**SMALL)
    step = FusedSteadyStep(cfg)
    args, images, seq = bench_arrays(cfg, step, n_images=2, n_points=400)
    jcfg = JaxConfig(**SMALL)
    jex = JaxExtractor(
        jcfg.n_features, jcfg.scale_factor, jcfg.n_levels, jcfg.ini_th_fast, jcfg.min_th_fast,
        cam=jcfg.cam, use_pallas=False,
    )
    jframe = jex(jnp.asarray(images[0].astype(np.float32) * (1.0 / 256.0)))
    n_lm = int(args[1][step.f_max + LOCAL_MAP_MAX])
    pred = (args[2] @ args[3]).astype(np.float32)
    sf = np.array([cfg.scale_factor**i for i in range(cfg.n_levels)], np.float32)
    inv_s2 = np.asarray(jex.inv_level_sigma2)[np.asarray(jframe.octave)]
    return dict(
        cfg=cfg, args=args, images=images, seq=seq, jframe=jframe, n_lm=n_lm, pred=pred,
        sf=sf, K=np.array(jcfg.cam.K), inv_s2=inv_s2,
    )


def _match_inputs(s, invariants: bool):
    n = s["n_lm"]
    _, _, _, _, pos, desc, valid, octave, normal, mind, maxd = s["args"]
    base = (pos[:n], desc[:n], valid[:n], octave[:n], s["pred"])
    extra = dict(pts_normal=normal[:n], pts_min_dist=mind[:n], pts_max_dist=maxd[:n]) if invariants else {}
    return base, extra


@pytest.mark.parametrize("radius,invariants", [(15.0, False), (30.0, False), (4.0, True)])
def test_search_by_projection_matches_jax(scene, radius, invariants):
    base, extra = _match_inputs(scene, invariants)
    want, proj_j, in_j = jax_search(
        *map(jnp.asarray, base), scene["jframe"], jnp.asarray(scene["K"]), jnp.asarray(radius),
        jnp.asarray(scene["sf"]), **{k: jnp.asarray(v) for k, v in extra.items()},
    )
    got, proj_t, in_t = search_by_projection(
        *map(torch.from_numpy, base), frame_to_torch(scene["jframe"]), torch.from_numpy(scene["K"]),
        radius, torch.from_numpy(scene["sf"]), **{k: torch.from_numpy(v) for k, v in extra.items()},
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() >= 20
    assert np.array_equal(in_t.numpy(), np.asarray(in_j))
    assert np.abs(proj_t.numpy() - np.asarray(proj_j)).max() < 1e-3


def test_pose_optimization_matches_jax(scene):
    base, _ = _match_inputs(scene, False)
    matches = np.asarray(
        jax_search(*map(jnp.asarray, base), scene["jframe"], jnp.asarray(scene["K"]),
                   jnp.asarray(15.0), jnp.asarray(scene["sf"]))[0]
    )
    jframe = scene["jframe"]
    n_feat = jframe.xy.shape[0]
    Xw = np.zeros((n_feat, 3), np.float32)
    has = np.zeros(n_feat, bool)
    ok = matches >= 0
    Xw[matches[ok]] = base[0][ok]
    has[matches[ok]] = True
    inputs = (scene["pred"], Xw, np.array(jframe.xy), scene["inv_s2"].astype(np.float32),
              has & np.asarray(jframe.valid), scene["K"])
    T_j, inl_j, n_j = jax_pose_opt(*map(jnp.asarray, inputs))
    T_t, inl_t, n_t, _ = pose_optimization(*map(torch.from_numpy, inputs))
    assert np.abs(T_t.numpy() - np.asarray(T_j)).max() < 1e-5
    assert np.array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= 10


def _pose_errors(T_a: np.ndarray, T_b: np.ndarray):
    dR = T_a[:3, :3] @ T_b[:3, :3].T
    rot = float(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
    return rot, float(np.linalg.norm(T_a[:3, 3] - T_b[:3, 3]))


def test_fused_step_matches_jax(scene):
    args = scene["args"]
    want = Tracking(JaxConfig(**SMALL))._build_fused_steady()(*map(jnp.asarray, args))
    step = FusedSteadyStep(scene["cfg"])
    with torch.no_grad():
        got = step(*state_from_numpy(args, "cpu"))
    T_j, vel_j = np.asarray(want[1]), np.asarray(want[3])
    assert bool(got[4]) == bool(want[4]) and bool(got[5]) == bool(want[5])
    assert bool(got[5]), "the small scene must track"
    n2_t, n2_j = int(got[6]), int(want[6])
    assert abs(n2_t - n2_j) <= 0.03 * n2_j
    rot, trans = _pose_errors(got[1].numpy(), T_j)
    assert rot < 1e-3 and trans < 1e-3
    assert np.abs(got[3].numpy() - vel_j).max() < 1e-3
    assert got[2].dtype == torch.int32 and got[2].shape == np.asarray(want[2]).shape


def _centre_error(T: np.ndarray, T_gt: np.ndarray) -> float:
    centre = -(T[:3, :3].T @ T[:3, 3])
    return float(np.linalg.norm(centre - (-(T_gt[:3, :3].T @ T_gt[:3, 3]))))


def test_bench_chain_matches_jax():
    """Both packages track chip_smoke.py's 10 frames of the benchmark scene
    (640x480, 512 features, 4 levels, 16384 landmark slots) with pose and
    velocity fed forward. The JAX errors are the ones chip_smoke.py's
    per-frame bound is twice of."""
    cfg = bench_config()
    step = FusedSteadyStep(cfg)
    n = len(chip_smoke.REFERENCE_CENTRE_ERR)
    args, images, seq = bench_arrays(cfg, step, n_images=n)
    jstep = Tracking(JaxConfig(n_features=512, n_levels=4, width=640, height=480))._build_fused_steady()
    jargs = [jnp.asarray(a) for a in args]
    targs = state_from_numpy(args, "cpu")
    T_j, V_j, T_t, V_t = jargs[3], jargs[2], targs[3], targs[2]
    for i, img in enumerate(images):
        want = jstep(jnp.asarray(img), jargs[1], V_j, T_j, *jargs[4:])
        with torch.no_grad():
            got = step(torch.from_numpy(img), targs[1], V_t, T_t, *targs[4:])
        T_j, V_j, T_t, V_t = want[1], want[3], got[1], got[3]
        assert bool(want[5]) and bool(got[5]), f"frame {i + 1} not tracked"
        assert abs(int(got[6]) - int(want[6])) <= 0.03 * int(want[6])
        assert np.abs(T_t.numpy() - np.asarray(T_j)).max() < 1e-3
        err_j = _centre_error(np.asarray(T_j), seq.poses[1 + i])
        assert abs(err_j - chip_smoke.REFERENCE_CENTRE_ERR[i]) < 5e-5
        assert _centre_error(T_t.numpy(), seq.poses[1 + i]) < 2.0 * chip_smoke.REFERENCE_CENTRE_ERR[i]


def test_state_from_numpy_contract(scene):
    state = state_from_numpy(scene["args"], "cpu")
    dtypes = [t.dtype for t in state]
    assert dtypes == [
        torch.uint16, torch.int32, torch.float32, torch.float32, torch.float32, torch.int8,
        torch.bool, torch.int32, torch.float32, torch.float32, torch.float32,
    ]
    with pytest.raises(ValueError):
        state_from_numpy((scene["args"][0].astype(np.float32),) + tuple(scene["args"][1:]), "cpu")


def test_port_imports_without_jax():
    """Every module of the port imports with jax made unimportable, and
    none pulls in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys; sys.modules['jax'] = None\n"
        "import orbslam_in_practice_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert {'orbslam_in_practice_tpu_torch.system', 'orbslam_in_practice_tpu_torch.run_slam',"
        " 'orbslam_in_practice_tpu_torch.slam.local_mapping', 'orbslam_in_practice_tpu_torch.optim.ba'} <= set(names)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'orbslam_in_practice_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
