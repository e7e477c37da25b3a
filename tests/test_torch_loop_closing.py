"""Loop closing of the port against the JAX package.

On tests/test_loop_closing.py's circle map (the tail revisits the start on
duplicate landmark slots), carried across with ``map_to_torch``:
``detect_candidates`` equal; ``compute_sim3`` with the same injected RANSAC
samples (``injected_jax_draws``): the same ``ok`` and inlier count, s, R, t
within 1e-3; ``close_loop`` from the same Sim3: keyframe poses and
landmarks within 3e-3 (one global BA, so as loose as a mapping epoch's
bound; landmarks without a depth constraint erased first); and the port
alone, drawing its own samples, closes the loop and at least halves the
injected drift. On tests/test_place_recognition.py's two
cases the port rejects the aliased cluster and accepts the true revisit, as
the JAX package does.
"""

import numpy as np
import pytest
import torch
from test_loop_closing import _aligned_rmse, _inject_drift, _make_loop_map
from test_place_recognition import N_LM, _add_cluster
from torch_parity import injected_jax_draws, map_to_torch

from orbslam_in_practice_tpu.config import SlamConfig as JaxConfig
from orbslam_in_practice_tpu.slam import loop_closing as jlc
from orbslam_in_practice_tpu.slam.map import SlamMap as JaxMap
from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.slam.local_mapping import LocalMapper
from orbslam_in_practice_tpu_torch.slam.loop_closing import LoopCloser

torch.set_num_threads(2)


def _port_config(cfg: JaxConfig) -> SlamConfig:
    return SlamConfig(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, k_max=cfg.k_max, l_max=cfg.l_max,
                      n_features=cfg.n_features, n_levels=cfg.n_levels)


def _loop_map(drift: bool):
    cfg, jmap, true_poses = _make_loop_map(np.random.default_rng(0))
    if drift:
        _inject_drift(jmap, jmap.n_kf)
    return cfg, jmap, true_poses


def _compute_sim3_both(monkeypatch, cfg, jmap, tmap, kf, cand):
    with injected_jax_draws(monkeypatch, jlc, "_sim3_ransac") as draws:
        want = jlc.LoopCloser(cfg).compute_sim3(jmap, kf, cand)
    got = LoopCloser(_port_config(cfg), "cpu").compute_sim3(
        tmap, kf, cand, sample_idx={seed - 2: idx for seed, idx in draws.items()}
    )
    return want, got, draws


@pytest.mark.parametrize("drift", [False, True])
def test_detect_and_compute_sim3_match_jax(monkeypatch, drift):
    cfg, jmap, _ = _loop_map(drift)
    tmap = map_to_torch(jmap)
    kf = jmap.n_kf - 1
    cands = jlc.LoopCloser(cfg).detect_candidates(jmap, kf)
    assert cands and LoopCloser(_port_config(cfg), "cpu").detect_candidates(tmap, kf) == cands
    want, got, draws = _compute_sim3_both(monkeypatch, cfg, jmap, tmap, kf, cands[0])
    assert 2 in draws
    assert got[0] == want[0] is True and got[4] == want[4] >= 20
    assert abs(got[1] - want[1]) < 1e-3
    assert np.abs(got[2] - np.asarray(want[2])).max() < 1e-3
    assert np.abs(got[3] - np.asarray(want[3])).max() < 1e-3


def test_close_loop_matches_jax(monkeypatch):
    """The same Sim3 on both sides. The map's landmarks seen by one keyframe
    only are erased first: they have no depth constraint, so global BA's
    float32 roundoff moves them along their rays, and the free monocular
    scale with them, differently in the two packages (by up to 0.08 and
    0.4%)."""
    cfg, jmap, _ = _loop_map(drift=True)
    tmap = map_to_torch(jmap)
    kf = jmap.n_kf - 1
    cand = jlc.LoopCloser(cfg).detect_candidates(jmap, kf)[0]
    want, _, _ = _compute_sim3_both(monkeypatch, cfg, jmap, tmap, kf, cand)
    ok, s, R, t, _ = want
    assert ok
    obs = jmap.kf_obs_host()[: jmap.n_kf]
    n_obs = np.bincount(obs[obs >= 0], minlength=jmap.l_max)
    jmap.erase_landmarks(np.nonzero(jmap.lm_valid_host() & (n_obs < 2))[0].astype(np.int32))
    tmap = map_to_torch(jmap)
    jlc.LoopCloser(cfg).close_loop(jmap, kf, cand, s, np.asarray(R), np.asarray(t))
    closer = LoopCloser(_port_config(cfg), "cpu")
    closer.close_loop(tmap, kf, cand, s, np.asarray(R), np.asarray(t))
    assert closer.n_closures == 1 and closer.last_closure == (kf, cand)
    assert np.abs(tmap.hview("kf_pose")[: jmap.n_kf] - jmap.hview("kf_pose")[: jmap.n_kf]).max() < 3e-3
    lm = np.nonzero(jmap.lm_valid_host())[0]
    assert np.array_equal(np.nonzero(tmap.lm_valid_host())[0], lm)
    assert np.abs(tmap.hview("lm_pos")[lm] - jmap.hview("lm_pos")[lm]).max() < 3e-3
    # the device tables follow host truth
    assert np.array_equal(tmap.kf_pose.numpy(), tmap.hview("kf_pose"))
    assert np.array_equal(tmap.lm_pos.numpy(), tmap.hview("lm_pos"))


def test_port_closes_loop_and_corrects_drift():
    cfg, jmap, true_poses = _loop_map(drift=True)
    tmap = map_to_torch(jmap)
    n = tmap.n_kf
    err_before = _aligned_rmse(jmap, true_poses, n)
    closer = LoopCloser(_port_config(cfg), "cpu")
    assert closer.attempt(tmap, n - 1, LocalMapper(_port_config(cfg), "cpu"))
    jmap.set_kf_poses(list(range(n)), tmap.hview("kf_pose")[:n])  # measured by the JAX test's own helper
    err_after = _aligned_rmse(jmap, true_poses, n)
    assert err_after < 0.5 * err_before, (err_before, err_after)
    (rec,) = closer.closures
    assert rec["kf"] == n - 1 and rec["inliers"] >= 20 and set(rec["ms"]) == {
        "lc_detect", "lc_sim3", "lc_correct", "lc_global_ba"}
    # the correction's sizes: every keyframe in the pose graph (the chain,
    # covisibility edges and the loop edge) and in global BA
    assert rec["graph_n"] == rec["ba_cams"] == tmap.n_kf_active() and rec["graph_e"] >= n
    assert 0 < rec["ba_points"] <= tmap.l_max and rec["ba_obs"] > rec["ba_points"]


@pytest.mark.parametrize("revisit", [False, True])
def test_place_recognition_cases(revisit):
    """Aliasing: the same texture on unrelated geometry 100 units away is
    retrieved but rejected; a true revisit of the same landmarks is
    accepted."""
    rng = np.random.default_rng(0)
    desc = np.where(rng.uniform(size=(128, 256)) > 0.5, 1, -1).astype(np.int8)
    X_a = np.stack([rng.uniform(-2, 2, N_LM), rng.uniform(-1.5, 1.5, N_LM), rng.uniform(4, 9, N_LM)], -1).astype(np.float32)
    X_b = np.stack([rng.uniform(-2, 2, N_LM), rng.uniform(-1.5, 1.5, N_LM), rng.uniform(4, 9, N_LM)], -1).astype(np.float32)
    X_b[:, 0] += 100.0
    offset_b = np.array([0.1, 0.05, 0.0] if revisit else [100.0, 0, 0], np.float32)
    jmap = JaxMap(k_max=32, l_max=512, f_max=128)
    _add_cluster(jmap, X_a, desc, lm_base=0, n_kf=6, offset=np.zeros(3, np.float32), seq_base=0)
    kfs_b = _add_cluster(jmap, X_a if revisit else X_b, desc, lm_base=N_LM, n_kf=6, offset=offset_b, seq_base=20)
    jmap.next_kf_id = 26
    cfg = JaxConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=128, n_levels=4)
    closer = LoopCloser(_port_config(cfg), "cpu")
    tmap = map_to_torch(jmap)
    query = kfs_b[-1]
    cands = closer.detect_candidates(tmap, query)
    assert cands == jlc.LoopCloser(cfg).detect_candidates(jmap, query)
    assert any(int(tmap.kf_seq[c]) < 10 for c in cands)
    if revisit:
        ok, s, _, _, n_inl = closer.compute_sim3(tmap, query, cands[0])
        assert ok and n_inl >= 20 and abs(s - 1.0) < 0.05
    else:
        assert not closer.attempt(tmap, query, LocalMapper(_port_config(cfg), "cpu")) and closer.n_closures == 0
