"""The port's asynchronous local mapping (``slam/async_mapping.py``) on the
CPU: tests/test_async_mapping.py's gates on its sequence and configuration
(strafe, 700 points, seed 3, 40 frames, 600 features), and the races the
worker path must survive.

- Quality: state OK, more than half the frames tracked, ATE < 0.05 (the
  JAX package's gates), one module-scoped run that also gives the
  throttle (the queue never holds more than QUEUE_MAX epochs) and the
  settled map after the drain (observations beyond the two-view set).
- ``reset`` drains the worker and the system initialises again.
- An epoch whose keyframe was removed while it was queued does nothing; an
  apply skips a keyframe removed while the stage waited for the device
  without the lock (a hook on the device wait removes it).
- A loop closure found on the worker rebases tracking: ``last_pose``
  becomes last_pose @ inv(pose_before) @ pose_now, within 1e-6.
- ``shutdown`` joins the worker even when the worker failed.
"""

import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.io.evaluation import ate_rmse
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch.slam.tracking import TrackingState
from orbslam_in_practice_tpu_torch.system import SlamSystem
from orbslam_in_practice_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

N_FRAMES = 40
SMALL = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=600, n_levels=4, fps=10.0,
             k_max=64, l_max=8192)


def async_system() -> SlamSystem:
    return SlamSystem(SlamConfig(**SMALL, async_mapping=True), device="cpu")


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=N_FRAMES, n_points=700, kind="strafe", seed=3)


@pytest.fixture(scope="module")
def run(seq):
    """The async system over the whole sequence, drained: its gates are
    read here, before later tests touch the system."""
    system = async_system()
    drv = system.tracker.async_driver
    n_tracked, max_pending = 0, 0
    for i in range(N_FRAMES):
        n_tracked += system.track_monocular(seq.render(i), i * 0.1) is not None
        max_pending = max(max_pending, drv.pending())
    idle = system.wait_idle(timeout=120.0)
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), seq.gt_centers())
    out = dict(n_tracked=n_tracked, max_pending=max_pending, idle=idle, state=system.state, rmse=rmse,
               n_aligned=n_aligned, stats=system.map.stats(), epochs=system.tracker.mapper.n_epochs)
    yield system, out
    system.shutdown()


def test_async_matches_sync_quality(run):
    _, out = run
    assert out["idle"] and out["state"] == TrackingState.OK
    assert out["n_tracked"] > N_FRAMES // 2 and out["n_aligned"] > N_FRAMES // 2
    assert out["rmse"] < 0.05, out["rmse"]


def test_async_queue_throttles(run):
    system, out = run
    assert 1 <= out["max_pending"] <= system.tracker.async_driver.QUEUE_MAX
    assert system.tracker.async_driver.pending() == 0


def test_async_map_settles_after_drain(run):
    _, out = run
    stats = out["stats"]
    assert stats["n_kf"] >= 2 and stats["n_lm"] > 50 and out["epochs"] >= 2
    # the drained epochs triangulated points beyond the two-view set
    assert stats["n_obs"] > stats["n_lm"] * 2 * 0.8


def test_async_reset_drains_and_restarts(seq):
    system = async_system()
    drv = system.tracker.async_driver
    for i in range(12):
        system.track_monocular(seq.render(i), i * 0.1)
    system.reset()
    assert drv.idle() and system.map.n_kf_active() == 0 and system.tracker._pending_closure_rebase is None
    n_tracked = sum(system.track_monocular(seq.render(i), i * 0.1) is not None for i in range(12, 28))
    assert system.wait_idle(timeout=120.0)
    assert n_tracked > 5
    system.shutdown()
    assert not drv.is_alive()


@pytest.fixture
def map_copy(run, tmp_path):
    """A fresh copy of the run's map (through a checkpoint) and a keyframe
    whose covisible window has at least two other keyframes."""
    system, _ = run
    system.save_map(str(tmp_path / "map.npz"))
    smap = checkpoint.load_map(str(tmp_path / "map.npz"), "cpu")
    covis = smap.covisibility()
    kf = max(smap.valid_keyframes_by_seq(), key=lambda k: int((covis[k] >= 15).sum()))
    assert (covis[kf] >= 15).sum() >= 2
    return smap, int(kf)


def _tables(smap):
    return {n: smap.hview(n).copy() for n in ("kf_pose", "kf_obs", "lm_pos", "lm_valid", "lm_desc_pm1")}


def test_epoch_of_a_keyframe_removed_while_queued_does_nothing(run, map_copy):
    system, _ = run
    smap, kf = map_copy
    mapper = system.tracker.mapper
    drv = system.tracker.async_driver
    seq_kf = int(smap.kf_seq[kf])
    n_epochs, n_done = mapper.n_epochs, drv.n_processed
    with smap.lock:  # the worker waits on the lock until the keyframe is gone
        drv.enqueue(smap, kf)
        smap.remove_keyframe(kf)
        before = _tables(smap)
    assert system.wait_idle(timeout=60.0)
    assert drv.n_processed == n_done + 1 and mapper.n_epochs == n_epochs
    for name, a in before.items():
        assert np.array_equal(smap.hview(name), a), name
    # the same through the mapper directly: a stale kf_seq, then a removed slot
    assert not mapper.process_new_keyframe(smap, kf, seq_kf)
    assert not mapper.process_new_keyframe(smap, kf)
    assert mapper.n_epochs == n_epochs


def test_apply_skips_a_keyframe_removed_during_the_device_wait(run, map_copy, monkeypatch):
    system, _ = run
    smap, kf = map_copy
    mapper = system.tracker.mapper
    covis = smap.covisibility()
    victim = int(np.argsort(-covis[kf])[0])
    assert victim != kf
    target = [victim]  # the keyframe the hook removes
    get = mapper._device_get

    def remove_then_get(*tensors):
        with smap.lock:
            if smap.kf_valid_host()[target[0]]:
                smap.remove_keyframe(target[0])
        return get(*tensors)

    written = []
    set_poses = smap.set_kf_poses
    monkeypatch.setattr(mapper, "_device_get", remove_then_get)
    monkeypatch.setattr(smap, "set_kf_poses", lambda ids, poses: (written.extend(ids), set_poses(ids, poses)))
    pose_victim = smap.hview("kf_pose")[victim].copy()
    mapper.local_ba(smap, kf)
    assert kf in written and victim not in written
    assert np.array_equal(smap.hview("kf_pose")[victim], pose_victim)
    assert not (smap.hview("kf_obs")[victim] >= 0).any()
    # the epoch's own keyframe removed during the wait: nothing is created
    target[0] = kf
    n_lm = smap.n_lm
    assert mapper.create_new_points(smap, kf) == 0 and smap.n_lm == n_lm


def test_worker_closure_rebases_tracking(run, monkeypatch):
    """A closure found on the worker path (the loop closer's attempt moves
    every keyframe by a known correction) is posted and applied when
    tracking next takes the lock: last_pose @ inv(pose_before) @ pose_now,
    velocity dropped."""
    system, _ = run
    tr = system.tracker
    smap = tr.map
    ref = tr.ref_kf
    assert ref >= 0 and smap.kf_valid_host()[ref]
    corr = np.eye(4, dtype=np.float32)
    c, s_ = np.cos(0.05), np.sin(0.05)
    corr[:3, :3] = [[c, -s_, 0], [s_, c, 0], [0, 0, 1]]
    corr[:3, 3] = [0.1, -0.05, 0.02]

    def closure(smap_, kf_id, mapper):
        kfs = smap_.valid_keyframes_by_seq()
        smap_.set_kf_poses(kfs, smap_.hview("kf_pose")[kfs] @ corr)
        return True

    monkeypatch.setattr(tr.mapper, "process_new_keyframe", lambda *a: True)
    monkeypatch.setattr(tr.loop_closer, "attempt", closure)
    pose_before = smap.hview("kf_pose")[ref].copy()
    last = tr.last_pose.numpy().copy()
    with smap.lock:
        tr.async_driver.enqueue(smap, ref)
    assert system.wait_idle(timeout=60.0)
    assert tr._pending_closure_rebase is not None
    assert tr._consume_async_events() and tr._pending_closure_rebase is None
    pose_now = smap.hview("kf_pose")[ref]
    assert np.abs(pose_now - pose_before @ corr).max() < 1e-6
    want = last @ np.linalg.inv(pose_before) @ pose_now
    assert np.abs(tr.last_pose.numpy() - want).max() < 1e-6
    assert tr.velocity is None and np.array_equal(tr._prev_pose.numpy(), tr.last_pose.numpy())


def test_shutdown_joins_after_a_worker_error(monkeypatch):
    system = async_system()
    tr = system.tracker

    def fail(*a):
        raise ValueError("epoch failed")

    monkeypatch.setattr(tr.mapper, "process_new_keyframe", fail)
    with tr.map.lock:
        tr.async_driver.enqueue(tr.map, 0)
    with pytest.raises(RuntimeError, match="epoch failed"):
        system.shutdown(timeout=30.0)
    assert not tr.async_driver.is_alive() and tr.async_driver.idle()


def test_driver_counts_survive_concurrent_enqueues():
    """Stress: 8 producer threads enqueue 400 epochs (a no-op mapper) with
    a 1 us switch interval; every epoch is processed exactly once and the
    pending count returns to 0 (a lost update of the count would leave it
    off, and drain would hang or return early)."""
    import sys
    import threading
    from types import SimpleNamespace

    from orbslam_in_practice_tpu_torch.slam.async_mapping import AsyncMapperDriver

    done = []
    mapper = SimpleNamespace(process_new_keyframe=lambda smap, kf, seq: done.append(kf) or False)
    smap = SimpleNamespace(kf_seq=np.zeros(8, np.int64))
    drv = AsyncMapperDriver(SimpleNamespace(device=torch.device("cpu"), mapper=mapper, loop_closer=None))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        producers = [threading.Thread(target=lambda: [drv.enqueue(smap, k % 8) for k in range(50)]) for _ in range(8)]
        for t in producers:
            t.start()
        for t in producers:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in producers)
        assert drv.drain(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert len(done) == drv.n_processed == 400 and drv.pending() == 0 and drv.idle()
    drv.shutdown(timeout=10.0)
    assert not drv.is_alive()


def test_drain_raises_when_the_worker_is_gone(monkeypatch):
    """A worker thread that exits with epochs pending makes drain raise
    instead of waiting for ever."""
    system = async_system()
    drv = system.tracker.async_driver
    drv.shutdown(timeout=10.0)  # the thread is gone; the next epoch is never taken
    with system.map.lock:
        drv.enqueue(system.map, 0)
    with pytest.raises(RuntimeError, match="exited with epochs pending"):
        drv.drain(timeout=5.0)
    with pytest.raises(RuntimeError, match="exited with epochs pending"):
        drv.drain()
