"""Parity of the port's SlamMap with the JAX package's.

Exact: every host table and counter (slots, free lists with quarantine,
kf_seq, lm_uid, observation counts, first-keyframe anchors) and the
covisibility counts after the same sequence of mutations, step by step;
the port's device tensors equal its host truth after every step. The
keyframe place descriptors are float32 means, compared within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import map_to_torch

from orbslam_in_practice_tpu.slam.map import SlamMap as JaxMap
from orbslam_in_practice_tpu_torch.frontend.frame import Frame
from orbslam_in_practice_tpu_torch.slam.map import _KF_DEVICE, _LM_DEVICE, TABLES, SlamMap

torch.set_num_threads(2)

N_FEAT = 64
COUNTERS = ("kf_frame_id", "kf_seq", "lm_first_kf", "lm_uid", "lm_obs_count", "n_kf", "n_lm", "next_kf_id",
            "_next_lm_uid", "_kf_free", "_lm_free", "_lm_free_pending")


class JaxFrame:
    """The attributes SlamMap.add_keyframe reads, as jax arrays."""

    def __init__(self, xy, valid, desc, octave, angle):
        self.n_features = len(xy)
        self.xy, self.valid, self.desc_pm1 = jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(desc)
        self.octave, self.angle = jnp.asarray(octave), jnp.asarray(angle)
        self.response = jnp.zeros(len(xy), jnp.float32)


def add_kf_both(jmap, tmap, rng, obs):
    xy = rng.uniform(0, 640, (N_FEAT, 2)).astype(np.float32)
    desc = rng.integers(0, 2, (N_FEAT, 256)).astype(np.int8) * 2 - 1
    valid = rng.uniform(size=N_FEAT) < 0.95
    octave = rng.integers(0, 4, N_FEAT).astype(np.int32)
    angle = rng.uniform(-3, 3, N_FEAT).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = rng.normal(size=3)
    obs = np.asarray(obs, np.int32)
    k_j = jmap.add_keyframe(JaxFrame(xy, valid, desc, octave, angle), jnp.asarray(pose), obs, jmap.n_kf)
    t = torch.from_numpy
    frame = Frame(xy=t(xy), xy_raw=t(xy), octave=t(octave), angle=t(angle), response=torch.zeros(N_FEAT),
                  valid=t(valid), desc_packed=torch.zeros((N_FEAT, 8), dtype=torch.int32), desc_pm1=t(desc))
    k_t = tmap.add_keyframe(frame, pose, obs, tmap.n_kf)
    assert k_j == k_t
    return k_t


def assert_maps_equal(jmap, tmap, where=""):
    for name in TABLES:
        a, b = np.asarray(jmap.hview(name)), tmap.hview(name)
        if name == "kf_gdesc":
            np.testing.assert_allclose(b, a, atol=1e-6, err_msg=f"{name} {where}")
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{name} {where}"
    for name in COUNTERS:
        a, b = getattr(jmap, name), getattr(tmap, name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f"{name} {where}"
    assert np.array_equal(jmap.covisibility(), tmap.covisibility()), where
    for name in _KF_DEVICE + _LM_DEVICE:
        assert np.array_equal(getattr(tmap, name).numpy(), tmap.hview(name)), f"device {name} {where}"


def _add_landmarks_both(jmap, tmap, rng, n):
    ids = jmap.allocate_landmarks(n)
    assert np.array_equal(tmap.allocate_landmarks(n), ids)
    if len(ids):
        args = (
            ids, rng.normal(size=(len(ids), 3)).astype(np.float32),
            rng.integers(0, 2, (len(ids), 256)).astype(np.int8) * 2 - 1,
            rng.normal(size=(len(ids), 3)).astype(np.float32), rng.integers(0, 4, len(ids)).astype(np.int32),
            rng.uniform(0, 1, len(ids)).astype(np.float32), rng.uniform(2, 9, len(ids)).astype(np.float32),
        )
        jmap.add_landmarks(*args, first_kf=-1)
        tmap.add_landmarks(*args, first_kf=-1)
    return ids


def test_mutation_sequence_matches_jax():
    """tests/test_map_ops.py's 60-step random mutation sequence (add
    keyframe, add observations, scrub, erase, replace, remove keyframe),
    applied to both maps: equal after every step, and the port's
    incremental covisibility equal to its full rebuild."""
    rng = np.random.default_rng(0)
    jmap = JaxMap(k_max=8, l_max=256, f_max=N_FEAT)
    tmap = SlamMap(k_max=8, l_max=256, f_max=N_FEAT)
    live = []
    for step in range(60):
        op = rng.integers(0, 6)
        if op == 0 or len(live) < 2:
            if tmap.keyframe_capacity() == 0:
                continue
            _add_landmarks_both(jmap, tmap, rng, int(rng.integers(0, 6)))
            valid_lms = np.nonzero(tmap.lm_valid_host())[0]
            obs = np.full(N_FEAT, -1, np.int64)
            if len(valid_lms):
                feats = rng.choice(N_FEAT, size=min(12, len(valid_lms)), replace=False)
                obs[feats] = rng.choice(valid_lms, size=len(feats), replace=False)
            live.append(add_kf_both(jmap, tmap, rng, obs))
        elif op == 1:
            k = int(rng.choice(live))
            row = tmap.kf_obs_host()[k]
            free = np.nonzero(row < 0)[0]
            bound = np.zeros(tmap.l_max, bool)
            bound[row[row >= 0]] = True
            valid_lms = np.nonzero(tmap.lm_valid_host() & ~bound)[0]
            n = min(4, len(free), len(valid_lms))
            if n:
                f, lms = rng.choice(free, n, replace=False), rng.choice(valid_lms, n, replace=False)
                jmap.add_observations(k, f, lms)
                tmap.add_observations(k, f, lms)
        elif op == 2:
            ko, fo = np.nonzero(tmap.kf_obs_host() >= 0)
            if len(ko):
                pick = rng.choice(len(ko), size=min(5, len(ko)), replace=False)
                jmap.scrub_observations(ko[pick], fo[pick])
                tmap.scrub_observations(ko[pick], fo[pick])
        elif op == 3:
            valid_lms = np.nonzero(tmap.lm_valid_host())[0]
            if len(valid_lms):
                ids = rng.choice(valid_lms, min(3, len(valid_lms)), replace=False).astype(np.int32)
                jmap.erase_landmarks(ids)
                tmap.erase_landmarks(ids)
        elif op == 4:
            valid_lms = np.nonzero(tmap.lm_valid_host())[0]
            if len(valid_lms) >= 2:
                a, b = rng.choice(valid_lms, 2, replace=False)
                jmap.replace_landmark(int(a), int(b))
                tmap.replace_landmark(int(a), int(b))
        elif op == 5 and len(live) > 2:
            k = int(rng.choice(live))
            jmap.remove_keyframe(k)
            tmap.remove_keyframe(k)
            live.remove(k)
        live = [k for k in live if tmap.kf_valid_host()[k]]
        assert_maps_equal(jmap, tmap, f"step {step}")
        inc = tmap.covisibility().copy()
        tmap._covis_dirty = True
        assert np.array_equal(inc, tmap.covisibility()), f"step {step}"


def test_eviction_and_slot_recycling_match_jax():
    """Keyframe eviction (most redundant first), keyframe slot reuse with
    monotonic seq, landmark quarantine until the next keyframe, pressure
    eviction of landmarks and the re-anchoring of first-keyframe links."""
    rng = np.random.default_rng(1)
    jmap = JaxMap(k_max=6, l_max=128, f_max=N_FEAT)
    tmap = SlamMap(k_max=6, l_max=128, f_max=N_FEAT)
    lm_a = _add_landmarks_both(jmap, tmap, rng, 20)
    lm_b = _add_landmarks_both(jmap, tmap, rng, 20)
    shared = np.full(N_FEAT, -1)
    shared[:20] = lm_a
    unique = np.full(N_FEAT, -1)
    unique[:20] = lm_b
    kfs = [add_kf_both(jmap, tmap, rng, shared) for _ in range(3)] + [add_kf_both(jmap, tmap, rng, unique)]
    for m in (jmap, tmap):
        m.lm_first_kf[lm_a] = kfs[0]
    assert_maps_equal(jmap, tmap, "built")
    assert jmap.evict_keyframe(np.array([kfs[2]])) == tmap.evict_keyframe(np.array([kfs[2]]))
    assert_maps_equal(jmap, tmap, "evicted")
    jmap.erase_landmarks(lm_b[:5])
    tmap.erase_landmarks(lm_b[:5])
    assert np.array_equal(jmap.allocate_landmarks(3), tmap.allocate_landmarks(3))  # quarantined: fresh slots
    add_kf_both(jmap, tmap, rng, np.full(N_FEAT, -1))
    assert np.array_equal(jmap.allocate_landmarks(4), tmap.allocate_landmarks(4))  # recycled
    protect = lm_a[:4]
    assert jmap.evict_landmarks(6, protect) == tmap.evict_landmarks(6, protect) == 6
    assert_maps_equal(jmap, tmap, "recycled")
    assert np.array_equal(jmap.valid_keyframes_by_seq(), tmap.valid_keyframes_by_seq())
    ids = tmap.keyframe_landmarks(kfs[2])
    assert all(np.array_equal(a, b) for a, b in zip(jmap.observations_of(ids), tmap.observations_of(ids)))
    assert jmap.stats() == tmap.stats()


def test_map_to_torch_carries_state():
    rng = np.random.default_rng(2)
    jmap = JaxMap(k_max=8, l_max=256, f_max=N_FEAT)
    tmap = SlamMap(k_max=8, l_max=256, f_max=N_FEAT)
    ids = _add_landmarks_both(jmap, tmap, rng, 30)
    for i in range(4):
        obs = np.full(N_FEAT, -1)
        obs[i : i + 20] = ids[i : i + 20]
        add_kf_both(jmap, tmap, rng, obs)
    for m in (jmap, tmap):
        m.erase_landmarks(ids[:2])
        m.remove_keyframe(1)
    carried = map_to_torch(jmap)
    assert_maps_equal(jmap, carried, "carried")
    assert carried.stats() == tmap.stats()
    pf = carried.pseudo_frame(2)
    assert np.array_equal(pf.desc_pm1.numpy(), np.asarray(jmap.hview("kf_desc_pm1")[2]))
    assert pf.n_features == N_FEAT and np.array_equal(pf.valid.numpy(), jmap.hview("kf_feat_valid")[2])


def test_add_keyframe_rejects_overflow():
    tmap = SlamMap(k_max=1, l_max=16, f_max=8)
    frame = Frame(*(torch.zeros((8, 2)),) * 2, torch.zeros(8, dtype=torch.int32), torch.zeros(8), torch.zeros(8),
                  torch.ones(8, dtype=torch.bool), torch.zeros((8, 8), dtype=torch.int32),
                  torch.ones((8, 256), dtype=torch.int8))
    tmap.add_keyframe(frame, np.eye(4), np.full(8, -1), 0)
    with pytest.raises(RuntimeError):
        tmap.add_keyframe(frame, np.eye(4), np.full(8, -1), 1)
    big = SlamMap(k_max=2, l_max=16, f_max=4)
    with pytest.raises(ValueError):
        big.add_keyframe(frame, np.eye(4), np.full(8, -1), 0)
