"""The port's copies of the JAX package's end-to-end regimes
(``orbslam_in_practice_tpu_torch/regimes.py``, which ``chip_smoke.py``
tracks on the card) against the JAX tests' own sequences and configurations
(``torch_regime_reference.build``, which imports them from the tests and
from tools/kitti_scale_probe.py): every configuration field equal, the same
frame count, trajectories within 1e-6 (relative past 1: the
KITTI turn's positions reach 40 m) and the last tracked frame rendered
within 1e-2 of the JAX package's render.

The KITTI corridor world places its quads along directions taken from
differences of nearby float32 path positions, 0.12 m apart, which amplify
the two packages' roundoff in the poses (a few ulps): a few quads of 10,000
move by up to 1.5 cm. There the quads must agree within 0.02 m, and all but
0.1% of the pixels within one gray level.
"""

import dataclasses

import numpy as np
import pytest
import torch_regime_reference as reference

from orbslam_in_practice_tpu_torch import regimes


@pytest.mark.parametrize("name", regimes.NAMES)
def test_regime_matches_its_jax_test(name):
    want_seq, want_cfg, want_n = reference.build(name)
    seq, cfg, n = regimes.build(name)
    assert n == want_n
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    assert seq.n_frames == want_seq.n_frames and seq.poses.shape == want_seq.poses.shape
    assert np.allclose(seq.poses, want_seq.poses, rtol=1e-6, atol=1e-6)
    assert np.abs(seq.pts - want_seq.pts).max() < (0.02 if name == "kitti_turn" else 1e-4)
    diff = np.abs(seq.render(n - 1) - want_seq.render(n - 1))
    if name == "kitti_turn":
        assert (diff > 1.0).mean() < 1e-3
    else:
        assert diff.max() < 1e-2
