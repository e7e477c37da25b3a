"""Shared helpers for the parity tests of the PyTorch port
(``tests/test_torch_*.py``) against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
JAX stays on the CPU (``conftest.py``).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu_torch.frontend.frame import Frame

# the small scene of the step parity tests: 320x240, 256 features, 3 levels,
# a principal point at the image centre like the renderer's
SMALL = dict(
    n_features=256, n_levels=3, width=320, height=240, cx=160.0, cy=120.0,
    l_max=2048, enable_loop_closing=False,
)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (the
    kernels have no CPU mode: their CPU path is the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def rendered_frame(width: int, height: int, seed: int = 0, dist=(0.0,) * 5, frame: int = 1):
    """A float32 rendered frame of a strafe scene."""
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(
        n_frames=frame + 1, n_points=400, width=width, height=height, seed=seed, dist=dist
    )
    return seq.render(frame).astype(np.float32)


def frame_to_torch(f) -> Frame:
    """A JAX package Frame -> the port's Frame (uint32 words as int32)."""
    arrays = {name: np.array(getattr(f, name)) for name in f._fields}
    arrays["desc_packed"] = arrays["desc_packed"].view(np.int32)
    return Frame(**{name: torch.from_numpy(a) for name, a in arrays.items()})


def map_to_torch(jmap, device="cpu"):
    """A JAX package SlamMap -> the port's SlamMap with the same state
    (host tables, counters, free lists; covisibility rebuilt)."""
    from orbslam_in_practice_tpu_torch.slam.map import _COUNTERS, TABLES, SlamMap

    tables = {name: np.array(jmap.hview(name)) for name in TABLES}
    for name in _COUNTERS + ("n_kf", "n_lm", "next_kf_id"):
        tables[name] = np.array(getattr(jmap, name))
    tables["next_lm_uid"] = jmap._next_lm_uid
    tables["kf_free"] = list(jmap._kf_free)
    tables["lm_free"] = list(jmap._lm_free)
    tables["lm_free_pending"] = list(jmap._lm_free_pending)
    return SlamMap.from_numpy(tables, device)


def wrapped_angle_error(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| wrapped to [0, pi]."""
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


@contextmanager
def injected_jax_draws(monkeypatch, module, name: str):
    """Run the JAX package's jitted ``module.name``, which draws RANSAC
    samples with ``jax.random.choice``, eagerly with the draws replaced by
    numpy ones seeded by the PRNG key's seed. Yields the dict seed -> drawn
    indices, which the port is then given. Nothing in the JAX package
    changes; the patches end with the test."""
    import jax
    import jax.numpy as jnp

    draws = {}

    def choice(key, a, shape=(), replace=True, p=None, axis=0):
        seed = int(np.asarray(key)[-1])  # PRNGKey(seed) is [0, seed]
        p64 = np.asarray(p, np.float64)
        idx = np.random.default_rng(seed).choice(int(a), size=shape, replace=replace, p=p64 / p64.sum())
        draws[seed] = idx
        return jnp.asarray(idx, jnp.int32)

    jitted = getattr(module, name)

    def eager(*args, **kwargs):
        with jax.disable_jit():
            return jitted(*args, **kwargs)

    monkeypatch.setattr(jax.random, "choice", choice)
    monkeypatch.setattr(module, name, eager)
    yield draws
