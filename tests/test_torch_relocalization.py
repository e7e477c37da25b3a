"""Relocalisation of the port against the JAX package, on
tests/test_relocalization.py's two scenarios (an aliased keyframe ranked
first whose landmarks are garbage, then the true one; and only garbage).
The JAX map is carried across with ``map_to_torch`` and both packages get
the same RANSAC samples (``injected_jax_draws``). Same ``ok``, keyframe,
observations and inlier count exactly; Tcw within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import frame_to_torch, injected_jax_draws, map_to_torch

from orbslam_in_practice_tpu.frontend.frame import Frame
from orbslam_in_practice_tpu.slam import relocalization as jreloc
from orbslam_in_practice_tpu.slam.map import SlamMap
from orbslam_in_practice_tpu_torch.slam.relocalization import relocalize

torch.set_num_threads(2)
K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
N_FEAT = 64
N_LM = 48


class _Cfg:
    n_levels = 4


class _JaxTracker:
    def __init__(self, smap):
        self.map, self.K, self.cfg = smap, jnp.asarray(K), _Cfg()
        self.inv_level_sigma2 = np.ones(4, np.float32)


class _TorchTracker:
    def __init__(self, smap):
        self.map, self.K, self.cfg = smap, torch.from_numpy(K), _Cfg()
        self.inv_level_sigma2 = torch.ones(4)


def _project(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]


def _frame(xy, desc_pm1, valid):
    n = len(xy)
    return Frame(
        xy=jnp.asarray(xy, jnp.float32), xy_raw=jnp.asarray(xy, jnp.float32), octave=jnp.zeros(n, jnp.int32),
        angle=jnp.zeros(n, jnp.float32), response=jnp.ones(n, jnp.float32), valid=jnp.asarray(valid),
        desc_packed=jnp.zeros((n, 8), jnp.uint32), desc_pm1=jnp.asarray(desc_pm1, jnp.int8),
    )


def _add_landmarks(smap, ids, X, desc, first_kf):
    n = len(ids)
    smap.add_landmarks(ids, X, desc, np.zeros((n, 3), np.float32), np.zeros(n, np.int32), np.zeros(n, np.float32),
                       np.full(n, np.inf, np.float32), first_kf=first_kf)


def _scenario(aliased_first: bool):
    """tests/test_relocalization.py's maps and query frames (same seeds)."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, N_LM), rng.uniform(-1.5, 1.5, N_LM), rng.uniform(4, 9, N_LM)], -1).astype(np.float32)
    desc = np.where(rng.uniform(size=(N_FEAT, 256)) > 0.5, 1, -1).astype(np.int8)
    T_true = np.eye(4, dtype=np.float32)
    if aliased_first:
        T_true[:3, 3] = [0.2, -0.1, 0.3]
    xy = np.zeros((N_FEAT, 2), np.float32)
    xy[:N_LM] = _project(T_true, X)
    valid = np.zeros(N_FEAT, bool)
    valid[:N_LM] = True
    smap = SlamMap(k_max=8, l_max=256, f_max=N_FEAT)
    obs_a = np.full(N_FEAT, -1, np.int32)
    obs_a[:N_LM] = np.arange(N_LM)
    kf_a = smap.add_keyframe(_frame(xy, desc, valid), jnp.asarray(T_true), obs_a, 0)
    if not aliased_first:  # every candidate's geometry is garbage
        X_bad = X[rng.permutation(N_LM)] + rng.normal(size=(N_LM, 3)).astype(np.float32) * 3.0
        _add_landmarks(smap, np.arange(N_LM, dtype=np.int32), X_bad, desc[:N_LM], kf_a)
        return smap, _frame(xy, desc, valid), None
    valid_b = valid.copy()
    valid_b[40:N_LM] = False
    obs_b = np.full(N_FEAT, -1, np.int32)
    obs_b[:40] = N_LM + np.arange(40)
    kf_b = smap.add_keyframe(_frame(xy, desc, valid_b), jnp.asarray(T_true), obs_b, 1)
    X_bad = X[rng.permutation(N_LM)] + rng.normal(size=(N_LM, 3)).astype(np.float32) * 2.0
    _add_landmarks(smap, np.arange(N_LM, dtype=np.int32), X_bad, desc[:N_LM], kf_a)
    _add_landmarks(smap, N_LM + np.arange(40, dtype=np.int32), X[:40], desc[:40], kf_b)
    T_q = T_true.copy()
    T_q[:3, 3] += [0.05, 0.02, -0.04]
    xy_q = np.zeros((N_FEAT, 2), np.float32)
    xy_q[:N_LM] = _project(T_q, X)
    return smap, _frame(xy_q, desc, valid), (kf_b, T_q)


@pytest.mark.parametrize("aliased_first", [True, False])
def test_relocalize_matches_jax(monkeypatch, aliased_first):
    jmap, frame, truth = _scenario(aliased_first)
    with injected_jax_draws(monkeypatch, jreloc, "_epnp_ransac") as draws:
        want = jreloc.relocalize(_JaxTracker(jmap), frame)
    assert draws, "the JAX package ran no RANSAC"
    tmap = map_to_torch(jmap)
    got = relocalize(_TorchTracker(tmap), frame_to_torch(frame), sample_idx={s - 1: i for s, i in draws.items()})
    ok, Tcw, obs, n_in, kf = got
    assert ok == want[0] == (truth is not None)
    assert (kf, n_in) == (want[4], want[3])
    if not ok:
        assert Tcw is None and obs is None
        return
    assert kf == truth[0] and n_in >= 10
    assert np.array_equal(obs, want[2])
    assert np.abs(Tcw - np.asarray(want[1])).max() < 1e-3
    assert np.abs(Tcw - truth[1]).max() < 0.02
