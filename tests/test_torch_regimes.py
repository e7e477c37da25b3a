"""The port's copies of the JAX package's end-to-end regimes
(``orbslam_in_practice_tpu_torch/regimes.py``, which ``chip_smoke.py``
tracks on the card) against the JAX tests' own sequences and configurations
(``torch_regime_reference.build``, which imports them from the tests and
from tools/kitti_scale_probe.py): every configuration field equal, the same
frame count, trajectories within 1e-6 (relative past 1: the
KITTI runs' positions reach tens of metres) and the last tracked frame
rendered within 1e-2 of the JAX package's render.

The KITTI corridor world places its quads along directions taken from
differences of nearby float32 path positions, which amplify the two
packages' roundoff in the poses (a few ulps). On the 500-frame world
(``kitti_turn``, ``kitti_500``), positions 0.12 m apart, 292 quads of
10,000 move by more than 1e-4 m and the most by 1.48 cm: the quads must
agree within 0.02 m. On the ``kitti_loop`` circuit, positions 0.35 m apart,
219 quads of 11,600 move by more than 1e-4 m and the most by 2.1 mm: within
3 mm. In every corridor world all but 0.1% of the last frame's pixels agree
within one gray level (measured: 0.010% at frame 159, 0.026% at frame 499,
0.004% at frame 579).
"""

import dataclasses

import numpy as np
import pytest
import torch_regime_reference as reference

from orbslam_in_practice_tpu_torch import regimes

QUAD_TOL = {"kitti_turn": 0.02, "kitti_500": 0.02, "kitti_loop": 0.003}  # m, the corridor worlds' quads


@pytest.mark.parametrize("name", regimes.NAMES)
def test_regime_matches_its_jax_test(name):
    want_seq, want_cfg, want_n = reference.build(name)
    seq, cfg, n = regimes.build(name)
    assert n == want_n
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert seq.n_frames == want_seq.n_frames and seq.poses.shape == want_seq.poses.shape
    assert np.allclose(seq.poses, want_seq.poses, rtol=1e-6, atol=1e-6)
    assert np.abs(seq.pts - want_seq.pts).max() < QUAD_TOL.get(name, 1e-4)
    diff = np.abs(seq.render(n - 1) - want_seq.render(n - 1))
    if name in QUAD_TOL:
        assert (diff > 1.0).mean() < 1e-3
    else:
        assert diff.max() < 1e-2
