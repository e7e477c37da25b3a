"""EPnP of the port against the JAX package, on the same numpy inputs.

``epnp`` on tests/test_pnp_sim3.py's noiseless problem and on its masked
hypothesis batch (the port's leading batch dim against the JAX package's
vmap): R and t within 1e-4, in float64 on both sides, since the float32
null space of the 12x12 M^T M differs between the two LAPACK builds by more
than that. ``epnp_ransac`` in float32 with the same injected samples on
both sides: the same inlier count exactly, R and t within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import injected_jax_draws

from orbslam_in_practice_tpu.geometry import se3 as jse3
from orbslam_in_practice_tpu.geometry.epnp import epnp as jax_epnp
from orbslam_in_practice_tpu.slam import relocalization as jreloc
from orbslam_in_practice_tpu_torch.geometry.epnp import epnp
from orbslam_in_practice_tpu_torch.slam.relocalization import MIN_SET, N_HYP, epnp_ransac

torch.set_num_threads(2)
K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])


def _problem(rng, n):
    """tests/test_pnp_sim3.py::make_pnp_problem in float64."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 10, n)], axis=-1)
    R = np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(size=3) * 0.3, jnp.float32)), np.float64)
    t = rng.normal(size=3) * 0.5
    pc = pts @ R.T + t
    pc[:, 2] = np.abs(pc[:, 2]) + 1.0
    pts = (pc - t) @ R
    uv = (pc[:, :2] / pc[:, 2:3]) * np.diag(K)[:2] + K[:2, 2]
    return pts, uv, R, t


def _jax64(f, *args):
    with jax.enable_x64(True):
        return [np.asarray(o) for o in f(*map(jnp.asarray, args))]


def test_epnp_exact_matches_jax_float64():
    pw, uv, R, t = _problem(np.random.default_rng(0), 32)
    R_j, t_j, e_j = _jax64(jax_epnp, pw, uv, K)
    R_t, t_t, e_t = epnp(*map(torch.from_numpy, (pw, uv, K)))
    assert np.abs(R_t.numpy() - R_j).max() < 1e-4 and np.abs(t_t.numpy() - t_j).max() < 1e-4
    assert np.abs(R_t.numpy() - R).max() < 1e-6 and float(e_t) < 1e-6


def test_epnp_masked_batch_matches_jax_float64():
    pw, uv, R, t = _problem(np.random.default_rng(1), 48)
    uv[:8] += 80.0  # 8 outliers; hypotheses sample 6 of the clean points
    rng = np.random.default_rng(1)
    masks = np.zeros((16, 48))
    for h in range(16):
        masks[h, rng.choice(np.arange(8, 48), size=6, replace=False)] = 1.0
    masks[-1, :8] = 1.0  # one hypothesis sees the outliers too
    with jax.enable_x64(True):
        want = jax.vmap(lambda m: jax_epnp(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(K), w=m))(jnp.asarray(masks))
        want = [np.asarray(o) for o in want]
    got = [o.numpy() for o in epnp(*map(torch.from_numpy, (pw, uv, K, masks)))]
    assert np.abs(got[0] - want[0]).max() < 1e-4 and np.abs(got[1] - want[1]).max() < 1e-4
    assert np.abs(got[2] - want[2]).max() < 1e-4 * max(1.0, np.abs(want[2]).max())
    assert np.abs(got[0][0] - R).max() < 1e-6  # a clean minimal set is exact


def test_epnp_ransac_injected_samples(monkeypatch):
    rng = np.random.default_rng(2)
    n = 96
    pw, uv, R, t = (a.astype(np.float32) for a in _problem(rng, n))
    uv[:20] += rng.uniform(-60, 60, (20, 2)).astype(np.float32)  # outliers
    uv[20:] += rng.normal(size=(n - 20, 2)).astype(np.float32) * 0.5
    valid = rng.uniform(size=n) < 0.9
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    with injected_jax_draws(monkeypatch, jreloc, "_epnp_ransac") as draws:
        R_j, t_j, n_j = jreloc._epnp_ransac(*map(jnp.asarray, (pw, uv, inv_s2, valid, K.astype(np.float32))),
                                            jax.random.PRNGKey(7))
    idx = draws[7]
    assert idx.shape == (N_HYP, MIN_SET) and valid[idx].all()
    R_t, t_t, n_t = epnp_ransac(*map(torch.from_numpy, (pw, uv, inv_s2, valid, K.astype(np.float32))),
                                sample_idx=torch.from_numpy(idx))
    assert int(n_t) == int(n_j) > 0.8 * valid[20:].sum()
    assert np.abs(R_t.numpy() - np.asarray(R_j)).max() < 1e-3
    assert np.abs(t_t.numpy() - np.asarray(t_j)).max() < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_epnp_ransac_draws_from_generator(seed):
    """Without injected samples the port draws valid correspondences only,
    the same ones for the same generator seed."""
    rng = np.random.default_rng(3)
    pw, uv, R, t = (torch.from_numpy(a.astype(np.float32)) for a in _problem(rng, 64))
    valid = torch.from_numpy(rng.uniform(size=64) < 0.5)
    args = (pw, uv, torch.ones(64), valid, torch.tensor(K, dtype=torch.float32))
    outs = [epnp_ransac(*args, generator=torch.Generator().manual_seed(seed)) for _ in range(2)]
    assert int(outs[0][2]) == int(outs[1][2]) == int(valid.sum())
    assert torch.equal(outs[0][0], outs[1][0])
    assert np.abs(outs[0][0].numpy() - R.numpy()).max() < 1e-3
