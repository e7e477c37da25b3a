"""Sim(3) of the port against the JAX package, on the same numpy inputs.

Tolerances: ``horn_sim3`` (s, R, t compared, never the sign-free
quaternion), ``exp_sim3``, ``log_sim3``, ``sim3_inverse`` and ``_calc_W``
within 1e-5 (float32, both sides); the per-edge pose-graph Jacobians within
1e-4, and finite on consistent edges, where the small-angle branch is taken
and the other branch divides by zero; ``optimize_pose_graph`` with the same
edges on tests/test_sim3_lie.py's drifted 10-vertex chain and on a graph of
the ``kitti_loop`` circuit's size (106 vertices, 515 chain and covisibility
edges, one loop edge at scale 0.913; positions up to 46 m, the packages
0.93e-4 apart): vertices within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu.geometry import sim3 as jsim3
from orbslam_in_practice_tpu.geometry import sim3_lie as jlie
from orbslam_in_practice_tpu.optim import pose_graph as jpg
from orbslam_in_practice_tpu_torch.geometry import sim3 as tsim3
from orbslam_in_practice_tpu_torch.geometry import sim3_lie as tlie
from orbslam_in_practice_tpu_torch.optim import pose_graph as tpg

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _tangents(rng, n=32):
    """Tangents over both W branches: generic, zero rotation, zero sigma,
    both zero."""
    xi = (rng.normal(size=(n, 7)) * 0.5).astype(np.float32)
    xi[:4, 3:6] = 0.0
    xi[4:8, 6] = 0.0
    xi[8:10, 3:] = 0.0
    return xi


@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_horn_sim3_matches_jax(with_scale, weighted):
    rng = np.random.default_rng(1)
    p1 = rng.normal(size=(6, 30, 3)).astype(np.float32)
    xi = (rng.normal(size=(6, 7)) * 0.4).astype(np.float32)
    G = np.asarray(jlie.exp_sim3(jnp.asarray(xi)))
    p2 = (p1 @ np.swapaxes(G[:, :3, :3], -1, -2) + G[:, None, :3, 3] + rng.normal(size=p1.shape) * 0.01).astype(np.float32)
    w = (rng.uniform(size=(6, 30)) < 0.7).astype(np.float32) if weighted else None
    want = jsim3.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), None if w is None else jnp.asarray(w), with_scale=with_scale)
    got = tsim3.horn_sim3(_t(p1), _t(p2), None if w is None else _t(w), with_scale=with_scale)
    for g, j in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(j)).max() < TOL * max(1.0, np.abs(np.asarray(j)).max())
    # one point set against a batch of masks broadcasts like the reference's vmap
    masks = (rng.uniform(size=(5, 30)) < 0.5).astype(np.float32)
    got_b = tsim3.horn_sim3(_t(p1[0]), _t(p2[0]), _t(masks), with_scale=with_scale)
    want_b = jax.vmap(lambda m: jsim3.horn_sim3(jnp.asarray(p1[0]), jnp.asarray(p2[0]), m, with_scale=with_scale))(jnp.asarray(masks))
    for g, j in zip(got_b, want_b):
        assert np.abs(g.numpy() - np.asarray(j)).max() < TOL * max(1.0, np.abs(np.asarray(j)).max())


def test_sim3_lie_matches_jax():
    rng = np.random.default_rng(2)
    xi = _tangents(rng)
    G_j = np.asarray(jlie.exp_sim3(jnp.asarray(xi)))
    G_t = tlie.exp_sim3(_t(xi))
    assert np.abs(G_t.numpy() - G_j).max() < TOL * np.abs(G_j).max()
    W_j = np.asarray(jlie._calc_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])))
    W_t = tlie._calc_W(_t(xi[:, 3:6]), _t(xi[:, 6]))
    assert np.abs(W_t.numpy() - W_j).max() < TOL
    log_j = np.asarray(jlie.log_sim3(jnp.asarray(G_j)))
    log_t = tlie.log_sim3(_t(G_j))
    assert np.abs(log_t.numpy() - log_j).max() < TOL * 10  # log amplifies float32 rounding of G
    inv_j = np.asarray(jlie.sim3_inverse(jnp.asarray(G_j)))
    assert np.abs(tlie.sim3_inverse(_t(G_j)).numpy() - inv_j).max() < TOL * np.abs(inv_j).max()
    T, s = tlie.sim3_to_se3(_t(G_j))
    T_j, s_j = jlie.sim3_to_se3(jnp.asarray(G_j))
    assert np.abs(T.numpy() - np.asarray(T_j)).max() < TOL and np.abs(s.numpy() - np.asarray(s_j)).max() < TOL
    back = tlie.se3_to_sim3(T, s).numpy()
    assert np.abs(back - np.asarray(jlie.se3_to_sim3(T_j, s_j))).max() < TOL * np.abs(G_j).max()


def _edges(rng, n_edges=12):
    xi = _tangents(rng, 3 * n_edges).reshape(3, n_edges, 7) * 0.5
    S = [np.array(jlie.exp_sim3(jnp.asarray(x))) for x in xi]
    # the last two edges are consistent (zero residual): S_m = S_j S_i^-1
    S[2][-2:] = S[1][-2:] @ np.linalg.inv(S[0][-2:])
    return [s.astype(np.float32) for s in S]


def test_edge_jacobians_match_jax():
    Si, Sj, Sm = _edges(np.random.default_rng(3))
    zero = np.zeros((len(Si), 7), np.float32)
    Ji_j, Jj_j = jpg._edge_jacobians(*map(jnp.asarray, (zero, zero, Si, Sj, Sm)))
    r_j = jpg._edge_residuals(*map(jnp.asarray, (zero, zero, Si, Sj, Sm)))
    Ji_t, Jj_t = tpg.edge_jacobians(*map(_t, (Si, Sj, Sm)))
    r_t = tpg.edge_residual(*map(_t, (zero, zero, Si, Sj, Sm)))
    assert Ji_t.dtype == Jj_t.dtype == torch.float32
    assert np.isfinite(Ji_t.numpy()).all() and np.isfinite(Jj_t.numpy()).all()
    assert np.abs(r_t.numpy()).max(axis=1)[-2:].max() < 1e-4  # consistent edges
    assert np.abs(r_t.numpy() - np.asarray(r_j)).max() < 1e-4
    assert np.abs(Ji_t.numpy() - np.asarray(Ji_j)).max() < 1e-4
    assert np.abs(Jj_t.numpy() - np.asarray(Jj_j)).max() < 1e-4


def drifted_chain(n=10):
    """tests/test_sim3_lie.py::test_pose_graph_closes_loop's problem: a line
    of poses with accumulating drift, odometry edges from the drifted
    estimate, one loop edge from the truth."""
    true_xi = np.zeros((n, 7), np.float32)
    true_xi[:, 0] = np.arange(n) * 0.5
    drift = np.zeros((n, 7), np.float32)
    drift[:, 1] = np.arange(n) * 0.05
    drift[:, 6] = np.arange(n) * 0.01
    S_true = np.asarray(jlie.exp_sim3(jnp.asarray(true_xi)))
    S_est = np.asarray(jlie.exp_sim3(jnp.asarray(true_xi + drift)))
    ei = list(range(n - 1)) + [0]
    ej = list(range(1, n)) + [n - 1]
    meas = [S_est[k + 1] @ np.linalg.inv(S_est[k]) for k in range(n - 1)] + [S_true[n - 1] @ np.linalg.inv(S_true[0])]
    w = [1.0] * (n - 1) + [10.0]
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return (S_est.astype(np.float32), np.array(ei, np.int32), np.array(ej, np.int32),
            np.stack(meas).astype(np.float32), np.array(w, np.float32), fixed), S_true


def circuit_graph(n=106, cand=7, kf=98, seed=0):
    """A pose graph of the ``kitti_loop`` circuit's size, built as
    ``LoopCloser.close_loop`` builds it: n keyframes driven around a 25 m
    circle whose estimate drifts in heading and shrinks in scale (to 0.9),
    the chain and the covisibility edges (2 to 5 insertions apart) measured
    from the estimate with weights 1-8, and one loop edge from the
    candidate ``cand`` (fixed) to ``kf`` measured from the truth at the
    drifted scale ratio. Returns (arguments, true poses, loop edge's
    scale)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 2 * np.pi * (n - 1) / (n - 8), n)
    up = np.array([0.0, 1.0, 0.0])
    T_true = np.tile(np.eye(4), (n, 1, 1))
    for k, a in enumerate(ang):
        centre = 25.0 * np.array([np.sin(a), 0.0, 1.0 - np.cos(a)])
        fwd = np.array([np.cos(a), 0.0, np.sin(a)])
        R_wc = np.stack([np.cross(up, fwd), up, fwd], axis=1)
        T_true[k, :3, :3] = R_wc.T
        T_true[k, :3, 3] = -R_wc.T @ centre
    scale = 1.0 - 0.1 * np.arange(n) / (n - 1)
    T_est = T_true.copy()
    for k in range(1, n):
        rel = T_true[k] @ np.linalg.inv(T_true[k - 1])
        yaw = 0.003 + rng.normal() * 0.001
        Ry = np.array([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0], [-np.sin(yaw), 0.0, np.cos(yaw)]])
        rel[:3, :3] = Ry @ rel[:3, :3]
        rel[:3, 3] *= scale[k]
        T_est[k] = rel @ T_est[k - 1]
    S = T_est.astype(np.float32)
    pairs = [(k, k + 1) for k in range(n - 1)] + [(i, i + d) for d in range(2, 6) for i in range(n - d)]
    s = scale[kf] / scale[cand]
    loop = T_true[kf] @ np.linalg.inv(T_true[cand])
    loop[:3, :] *= s
    meas = np.stack([S[j] @ np.linalg.inv(S[i]) for i, j in pairs] + [loop]).astype(np.float32)
    w = np.concatenate([np.maximum(rng.uniform(0.5, 8.0, n - 1), 1.0), rng.uniform(1.0, 8.0, len(pairs) - n + 1), [5.0]])
    fixed = np.zeros(n, bool)
    fixed[cand] = True
    ei = np.array([i for i, _ in pairs] + [cand], np.int32)
    ej = np.array([j for _, j in pairs] + [kf], np.int32)
    return (S, ei, ej, meas, w.astype(np.float32), fixed), T_true, s


@pytest.mark.parametrize("graph", ["chain10", "circuit106"])
def test_optimize_pose_graph_matches_jax(graph):
    if graph == "chain10":
        args, S_true = drifted_chain()
    else:
        args, S_true, s = circuit_graph()
        assert len(args[0]) == 106 and len(args[1]) == 516 and 0.9 < s < 0.92
    want = np.asarray(jpg.optimize_pose_graph(*map(jnp.asarray, args), iterations=tpg.ITERATIONS))
    got = tpg.optimize_pose_graph(*map(_t, args)).numpy()
    assert np.abs(got - want).max() < 1e-3
    fixed = np.nonzero(args[5])[0]
    assert np.array_equal(got[fixed], args[0][fixed])  # the fixed vertex stays
    if graph == "chain10":
        n = len(S_true)
        assert np.linalg.norm(got[n - 1] - S_true[n - 1]) < 0.1 * np.linalg.norm(args[0][n - 1] - S_true[n - 1])
        return
    # the loop edge's residual falls by over 50x
    zero = torch.zeros((1, 7))
    loop = [_t(a[None, k]) for a, k in ((args[0], args[1][-1]), (args[0], args[2][-1]))]
    before = float(tpg.edge_residual(zero, zero, *loop, _t(args[3][-1:])).norm())
    after = float(tpg.edge_residual(zero, zero, _t(got[None, args[1][-1]]), _t(got[None, args[2][-1]]),
                                    _t(args[3][-1:])).norm())
    assert after < before / 50
