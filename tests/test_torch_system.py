"""The port's SlamSystem end to end on the CPU, against tests/test_e2e.py's
gates on the same sequence (strafe, 700 points, seed 3, 40 frames) and
configuration (tests/test_e2e.py's small_config, loop closing on): state
OK, >= 2 keyframes, > 50 landmarks, more than half the frames tracked, ATE
< 0.05; the fused and the unfused flows each under ATE 0.05 after 24
frames; lost and relocalised (tests/test_e2e.py's kidnapped camera: pose
within 0.06 in translation and 0.05 in rotation of its earlier estimate).
Loop closing closes nothing on the strafe, like the JAX package (0
closures, its CPU run at this configuration), and on the port's final map
carried across by checkpoint the JAX package detects the same candidates
for every keyframe (on this short strafe none survives the covisibility
and temporal guards). Checkpoints load across packages with the tables equal.
Trajectory export and ATE evaluation match the JAX package's on the same
trajectory: ATE within 1e-5, exported numbers within 1e-6.
``async_mapping`` starts the mapping worker (tests/test_torch_async_mapping.py
tests it).
"""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu.config import SlamConfig as JaxConfig
from orbslam_in_practice_tpu.io import evaluation as jeval
from orbslam_in_practice_tpu.io import trajectory as jtraj
from orbslam_in_practice_tpu.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu.slam.loop_closing import LoopCloser as JaxLoopCloser
from orbslam_in_practice_tpu.slam.map import SlamMap as JaxMap
from orbslam_in_practice_tpu.utils import checkpoint as jckpt
from orbslam_in_practice_tpu_torch import run_slam
from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.io import evaluation, trajectory
from orbslam_in_practice_tpu_torch.slam.tracking import TrackingState, Tracking
from orbslam_in_practice_tpu_torch.system import SlamSystem
from orbslam_in_practice_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

N_FRAMES = 40
COMPARE_AT = 24  # tests/test_e2e.py's fused-vs-unfused length
JAX_CLOSURES = 0  # the JAX package's SlamSystem on this sequence and configuration
SMALL = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=600, n_levels=4, fps=10.0,
             k_max=64, l_max=8192)


def small_config():
    return SlamConfig(**SMALL)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=N_FRAMES, n_points=700, kind="strafe", seed=3)


def _run(seq, n_frames, fused: bool, snapshot_at: int | None = None):
    system = SlamSystem(small_config(), device="cpu")
    system.tracker.use_fused = fused
    n_tracked, snapshot, paths = 0, None, []
    for i in range(n_frames):
        n_tracked += system.track_monocular(seq.render(i), i * 0.1) is not None
        paths.append((system.tracker.frame_path, system.tracker.frame_keyframe))
        if i + 1 == snapshot_at:
            snapshot = (system.state, system.get_trajectory())
    return system, n_tracked, snapshot, paths


@pytest.fixture(scope="module")
def fused_run(seq):
    return _run(seq, N_FRAMES, fused=True, snapshot_at=COMPARE_AT)


def test_system_initializes_and_tracks(seq, fused_run):
    system, n_tracked, _, _ = fused_run
    assert system.state == TrackingState.OK
    stats = system.map.stats()
    assert stats["n_kf"] >= 2
    assert stats["n_lm"] > 50
    assert n_tracked > seq.n_frames // 2
    rmse, n_aligned, _ = evaluation.ate_rmse(system.get_trajectory(), seq.gt_centers())
    assert n_aligned > seq.n_frames // 2
    assert rmse < 0.05
    assert system.tracker.n_fused_frames > 0
    # the device tables equal host truth after a whole run
    m = system.map
    for name in ("lm_pos", "lm_valid", "lm_desc_pm1", "lm_normal", "lm_min_dist", "lm_max_dist", "lm_octave",
                 "kf_pose", "kf_xy", "kf_octave", "kf_angle", "kf_feat_valid", "kf_desc_pm1"):
        assert np.array_equal(getattr(m, name).numpy(), m.hview(name)), name


@pytest.mark.parametrize("fused", [True, False])
def test_system_fused_and_unfused_track(seq, fused_run, fused):
    if fused:
        state, traj = fused_run[2]
    else:
        system, _, _, paths = _run(seq, COMPARE_AT, fused=False)
        assert {p for p, _ in paths} <= {"init", "unfused"}
        state, traj = system.state, system.get_trajectory()
        assert system.tracker.n_fused_frames == 0
    assert state == TrackingState.OK
    assert evaluation.ate_rmse(traj, seq.gt_centers())[0] < 0.05


def test_frame_paths_account_for_every_fused_launch(fused_run):
    """Each frame's recorded path: initialisation first, the first frame
    after it unfused (no velocity yet), and exactly as many frames on a
    fused path as the fused step ran; the keyframe flags match the
    local-mapping epochs."""
    system, _, _, paths = fused_run
    kinds = [p for p, _ in paths]
    first = kinds.index("unfused")
    assert first > 0 and set(kinds[:first]) == {"init"}
    assert sum(k in ("fused", "fused_fallback") for k in kinds) == system.tracker.n_fused_frames
    assert sum(kf for _, kf in paths) == system.tracker.mapper.n_epochs > 0


def test_trajectory_export_and_ate_match_jax(tmp_path, seq, fused_run):
    traj = fused_run[0].get_trajectory()
    got = evaluation.ate_rmse(traj, seq.gt_centers())
    want = jeval.ate_rmse(traj, seq.gt_centers())
    assert abs(got[0] - want[0]) < 1e-5 and got[1:] == want[1:]
    got_se3 = evaluation.ate_rmse(traj, seq.gt_centers(), align_scale=False)[0]
    assert abs(got_se3 - jeval.ate_rmse(traj, seq.gt_centers(), align_scale=False)[0]) < 1e-5
    for save_t, save_j, cols in ((trajectory.save_tum, jtraj.save_tum, 8), (trajectory.save_kitti, jtraj.save_kitti, 12)):
        save_t(str(tmp_path / "port.txt"), traj)
        save_j(str(tmp_path / "jax.txt"), traj)
        a = np.loadtxt(tmp_path / "port.txt")
        b = np.loadtxt(tmp_path / "jax.txt")
        assert a.shape == b.shape == (sum(T is not None for _, _, T in traj), cols)
        assert np.abs(a - b).max() < 1e-6
    fused_run[0].save_trajectory_tum(str(tmp_path / "system.txt"))
    trajectory.save_tum(str(tmp_path / "direct.txt"), traj)
    assert (tmp_path / "system.txt").read_text() == (tmp_path / "direct.txt").read_text()


@pytest.mark.parametrize("field", ["async_mapping"])
def test_unported_settings_raise(field):
    """Every setting of the JAX package is ported now: async_mapping no
    longer raises; it starts the mapping worker, which shutdown joins."""
    cfg = dataclasses.replace(small_config(), **{field: True})
    tracker = Tracking(cfg, device="cpu")
    driver = tracker.async_driver
    assert driver is not None and driver.is_alive() and driver.idle()
    driver.shutdown(timeout=10.0)
    assert not driver.is_alive()
    assert Tracking(small_config(), device="cpu").async_driver is None


def test_lost_and_relocalize(seq):
    """tests/test_e2e.py::test_e2e_lost_and_relocalize on the port: track 28
    frames, blind the camera until LOST, show frame 20 again and recover
    its earlier pose, then keep tracking. A young map (<= 5 keyframes) is
    reset instead."""
    young = SlamSystem(small_config(), device="cpu")
    young.tracker.state = TrackingState.LOST
    assert young.track_monocular(seq.render(0), 0.0) is None
    assert young.state == TrackingState.NOT_INITIALIZED and young.tracker.frame_path == "reset"
    system = SlamSystem(small_config(), device="cpu")
    poses = {}
    for i in range(28):
        p = system.track_monocular(seq.render(i), i * 0.1)
        if p is not None:
            poses[i] = p
    assert system.state == TrackingState.OK and 20 in poses and system.map.n_kf_active() > 5
    blank = np.zeros((480, 640), np.float32)
    for k in range(3):
        system.track_monocular(blank, 3.0 + 0.1 * k)
    assert system.state == TrackingState.LOST
    p = system.track_monocular(seq.render(20), 4.0)
    assert system.state == TrackingState.OK and system.tracker.frame_path == "reloc" and p is not None
    assert np.abs(p[:3, 3] - poses[20][:3, 3]).max() < 0.06
    assert np.abs(p[:3, :3] - poses[20][:3, :3]).max() < 0.05
    assert system.tracker.last_reloc_frame_id == system.tracker.frame_id
    p2 = system.track_monocular(seq.render(21), 4.1)
    assert p2 is not None and system.state == TrackingState.OK


def _jax_map_from(path, smap):
    jmap = JaxMap(smap.k_max, smap.l_max, smap.f_max)
    jckpt.load_map(str(path), jmap)
    return jmap


def test_loop_closing_on_the_strafe_matches_jax(tmp_path, fused_run):
    system = fused_run[0]
    closer = system.tracker.loop_closer
    assert closer is not None and closer.n_closures == JAX_CLOSURES
    assert closer.n_attempts > 0 and closer.stage_s["lc_detect"] > 0
    smap = system.map
    system.save_map(str(tmp_path / "map.npz"))
    jmap = _jax_map_from(tmp_path / "map.npz", smap)
    jmap.kf_gdesc = smap.hview("kf_gdesc")  # the JAX checkpoint does not hold them
    jlc = JaxLoopCloser(JaxConfig(**SMALL))
    for kf in smap.valid_keyframes_by_seq():
        cands = closer.detect_candidates(smap, int(kf))
        assert cands == jlc.detect_candidates(jmap, int(kf))
        for c in cands:
            assert not jlc.compute_sim3(jmap, int(kf), c)[0]
            assert not closer.compute_sim3(smap, int(kf), c)[0]


def test_checkpoint_loads_across_packages(tmp_path, fused_run):
    """A map saved by the port loads in the JAX package and the reverse,
    with every checkpointed table equal; the port's loaded map has its
    global descriptors back and its device tables equal to host truth."""
    system = fused_run[0]
    smap = system.map
    system.save_map(str(tmp_path / "port.npz"))
    jmap = _jax_map_from(tmp_path / "port.npz", smap)
    jckpt.save_map(str(tmp_path / "jax.npz"), jmap)
    loaded = SlamSystem(small_config(), device="cpu")
    loaded.load_map(str(tmp_path / "jax.npz"))
    tmap = loaded.map
    assert loaded.tracker.map is tmap and tmap.on_kf_removed == loaded.tracker._reanchor_trajectory
    for name in checkpoint.ARRAY_FIELDS:
        assert np.array_equal(jmap.hview(name), smap.hview(name)), name
        assert np.array_equal(tmap.hview(name), smap.hview(name)), name
    for name in checkpoint.HOST_FIELDS + ("n_kf", "n_lm", "next_kf_id", "_next_lm_uid"):
        assert np.array_equal(getattr(jmap, name), getattr(smap, name)), name
        assert np.array_equal(getattr(tmap, name), getattr(smap, name)), name
    assert tmap.stats() == jmap.stats()
    assert np.abs(tmap.hview("kf_gdesc") - smap.hview("kf_gdesc")).max() < 1e-6
    assert np.array_equal(tmap.covisibility(), smap.covisibility())
    for name in ("lm_pos", "kf_pose", "kf_desc_pm1"):
        assert np.array_equal(getattr(tmap, name).numpy(), tmap.hview(name)), name


def test_run_slam_cli(capsys):
    out = run_slam.main(["--synthetic", "--frames", "3", "--device", "cpu"])
    assert out["frames"] == 3 and out["frame_count"]["init"] == 3 and out["device"] == "cpu"
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            run_slam.main(["--synthetic", "--frames", "3"])
