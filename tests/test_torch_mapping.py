"""Parity of the port's local mapping with the JAX package's.

The JAX package's SlamSystem tracks the e2e strafe sequence (seed 3) until
its 4th keyframe; the map is captured just before that keyframe's epoch
and carried to the port with ``map_to_torch``. Both packages then run the
epoch's stages on their own copy. Tolerances: new-point creation, fusion,
local BA's outlier scrub and recent-landmark culling are exact in their
bookkeeping (the same landmarks, observations and counts). Positions are
compared relative to their distance from the origin: triangulated ones
within 5e-3 (median 1e-3), since the float32 ``eigh`` of a low-parallax DLT
system is conditioned by its second-smallest eigenvalue (measured: max
1.0e-3, median 2.3e-4); after local BA (10 float32 LM iterations, sums in
another order) within 1e-2 (median 1e-3; measured max 2.9e-3) and poses
within 1e-4. Refreshed normals agree within 1e-4, distance bounds within
1e-3 relative, descriptors and octaves exactly.
"""

import copy
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import map_to_torch

from orbslam_in_practice_tpu.config import SlamConfig as JaxConfig
from orbslam_in_practice_tpu.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu.slam import local_mapping as jlm
from orbslam_in_practice_tpu.system import SlamSystem as JaxSystem
from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.slam import local_mapping as tlm

torch.set_num_threads(2)

E2E = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=600, n_levels=4,
           fps=10.0, k_max=64, l_max=8192, enable_loop_closing=False)


@pytest.fixture(scope="module")
def epoch():
    """(JAX map copy, keyframe, recent landmarks) just before the JAX
    system's 4th keyframe epoch, and the JAX system's config."""
    seq = SyntheticSequence(n_frames=8, n_points=700, kind="strafe", seed=3)
    system = JaxSystem(JaxConfig(**E2E))
    mapper = system.tracker.mapper
    run_epoch = mapper.process_new_keyframe
    snap = {}

    def capture(smap, kf_id, **kw):
        if smap.n_kf_active() == 4 and not snap:
            snap["map"] = _copy_jax_map(smap)
            snap["kf"] = kf_id
            snap["recent"] = list(mapper._recent_lms)
        return run_epoch(smap, kf_id, **kw)

    mapper.process_new_keyframe = capture
    for i in range(seq.n_frames):
        system.track_monocular(seq.render(i), 0.1 * i)
        if snap:
            break
    assert snap, "the JAX system made no 4th keyframe"
    return snap, system


def _mappers(epoch):
    """Fresh copies for one test: (JAX map, port map, JAX mapper, port
    mapper, keyframe)."""
    snap, system = epoch
    jmap = _copy_jax_map(snap["map"])
    tmap = map_to_torch(snap["map"])
    jl = jlm.LocalMapper(system.cfg, system.tracker.extractor)
    tl = tlm.LocalMapper(SlamConfig(**E2E), device="cpu")
    jl._recent_lms = list(snap["recent"])
    tl._recent_lms = list(snap["recent"])
    return jmap, tmap, jl, tl, snap["kf"]


def _copy_jax_map(smap):
    """A deep copy of a JAX SlamMap (its RLock cannot be copied)."""
    lock, smap.lock = smap.lock, None
    try:
        out = copy.deepcopy(smap)
    finally:
        smap.lock = lock
    out.lock = threading.RLock()
    return out


def _assert_bookkeeping_equal(jmap, tmap):
    for name in ("kf_obs", "kf_valid", "lm_valid", "kf_feat_valid"):
        assert np.array_equal(np.asarray(jmap.hview(name)), tmap.hview(name)), name
    for name in ("lm_obs_count", "lm_uid", "lm_first_kf", "n_lm"):
        assert np.array_equal(np.asarray(getattr(jmap, name)), np.asarray(getattr(tmap, name))), name
    assert np.array_equal(jmap.covisibility(), tmap.covisibility())


def _assert_positions_close(jmap, tmap, ids, max_rel, median_rel):
    """Landmark positions relative to their distance from the keyframe-0
    origin: every one within max_rel, the median within median_rel."""
    a, b = tmap.hview("lm_pos")[ids], np.asarray(jmap.hview("lm_pos"))[ids]
    rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
    assert rel.max() < max_rel and np.median(rel) < median_rel


def test_epoch_stages_match_jax(epoch):
    jmap, tmap, jl, tl, kf = _mappers(epoch)
    assert jl.cull_landmarks(jmap, kf) == tl.cull_landmarks(tmap, kf)
    n_lm0 = tmap.n_lm_active()
    n_new = jl.create_new_points(jmap, kf)
    assert tl.create_new_points(tmap, kf) == n_new > 20
    _assert_bookkeeping_equal(jmap, tmap)
    new = np.nonzero(tmap.hview("lm_valid") & (tmap.lm_first_kf == kf))[0]
    assert len(new) == n_new and tmap.n_lm_active() == n_lm0 + n_new
    _assert_positions_close(jmap, tmap, new, 5e-3, 1e-3)
    assert jl.fuse_neighbors(jmap, kf) == tl.fuse_neighbors(tmap, kf) > 0
    _assert_bookkeeping_equal(jmap, tmap)
    jl.local_ba(jmap, kf)
    tl.local_ba(tmap, kf)
    _assert_bookkeeping_equal(jmap, tmap)
    assert np.abs(tmap.hview("kf_pose") - np.asarray(jmap.hview("kf_pose"))).max() < 1e-4
    _assert_positions_close(jmap, tmap, np.nonzero(tmap.hview("lm_valid"))[0], 1e-2, 1e-3)
    ids = tmap.keyframe_landmarks(kf)
    jl.refresh_landmarks(jmap, ids)
    tl.refresh_landmarks(tmap, ids)
    assert np.array_equal(tmap.hview("lm_desc_pm1")[ids], np.asarray(jmap.hview("lm_desc_pm1"))[ids])
    assert np.array_equal(tmap.hview("lm_octave")[ids], np.asarray(jmap.hview("lm_octave"))[ids])
    assert np.abs(tmap.hview("lm_normal")[ids] - np.asarray(jmap.hview("lm_normal"))[ids]).max() < 1e-4
    for name in ("lm_min_dist", "lm_max_dist"):
        a, b = tmap.hview(name)[ids], np.asarray(jmap.hview(name))[ids]
        assert np.all(np.abs(a - b) <= 1e-3 * np.abs(b)), name
    for name in ("lm_pos", "lm_valid", "lm_desc_pm1", "lm_normal", "kf_pose"):
        assert np.array_equal(getattr(tmap, name).numpy(), tmap.hview(name)), name


def test_process_new_keyframe_matches_jax(epoch):
    jmap, tmap, jl, tl, kf = _mappers(epoch)
    n_lm0 = tmap.n_lm_active()
    jl.process_new_keyframe(jmap, kf)
    tl.process_new_keyframe(tmap, kf)
    assert tmap.n_lm_active() == jmap.n_lm_active() > n_lm0
    _assert_bookkeeping_equal(jmap, tmap)
    _assert_positions_close(jmap, tmap, np.nonzero(tmap.hview("lm_valid"))[0], 1e-2, 1e-3)
    assert tl.n_epochs == 1 and set(tl.stage_s) == {"kf_create", "kf_fuse", "kf_local_ba", "kf_cull", "kf_refresh"}


def test_landmark_invariants_match_jax():
    """Random keyframe tables and observation sets, odd and even counts."""
    rng = np.random.default_rng(0)
    K, F, L, O = 6, 40, 50, jlm.O_MAX
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(K, 3))
    desc = rng.integers(0, 2, (K, F, 256)).astype(np.int8) * 2 - 1
    octv = rng.integers(0, 4, (K, F)).astype(np.int32)
    lm_pos = (rng.normal(size=(L, 3)) + [0, 0, 6]).astype(np.float32)
    obs_kf = rng.integers(0, K, (L, O)).astype(np.int32)
    obs_feat = rng.integers(0, F, (L, O)).astype(np.int32)
    counts = rng.integers(0, O + 1, L)
    obs_val = np.arange(O)[None] < counts[:, None]
    want = jlm._landmark_invariants(*map(jnp.asarray, (lm_pos, poses, desc, octv, obs_kf, obs_feat, obs_val)),
                                    jnp.asarray(1.2, jnp.float32), jnp.asarray(4, jnp.int32))
    got = tlm._landmark_invariants(*map(torch.from_numpy, (lm_pos, poses, desc, octv, obs_kf.astype(np.int64),
                                                           obs_feat.astype(np.int64), obs_val)), 1.2, 4)
    normal, mind, maxd, d, o = (np.asarray(w) for w in want)
    has = counts > 0
    assert np.abs(got[0].numpy() - normal)[has].max() < 1e-5
    assert np.all(np.abs(got[1].numpy() - mind)[has] <= 1e-5 * mind[has])
    assert np.all(np.abs(got[2].numpy() - maxd)[has] <= 1e-5 * maxd[has])
    assert np.array_equal(got[3].numpy()[has], d[has]) and np.array_equal(got[4].numpy()[has], o[has])
