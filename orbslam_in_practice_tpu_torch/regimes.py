"""The JAX package's end-to-end regimes as the port's sequences and
configurations.

Each regime copies one end-to-end test of the JAX package: its rendered
sequence, its ``SlamConfig`` and the number of frames it tracks.

- ``strafe``, ``forward``, ``rotation``: tests/test_e2e_motion_regimes.py,
  700 points, seed 3, pixel noise 1.0, 10% exposure jitter; 640x480, 1000
  features, 4 levels, 64 keyframe and 8192 landmark slots; 40, 50 and 50
  frames.
- ``distortion``: tests/test_e2e_distortion.py, the strafe through TUM1's
  radial-tangential lens (``DIST``) at 600 features, 40 frames.
- ``no_false_loop``: tests/test_e2e_long_sequence.py's negative control, a
  noisy strafe (seed 11) that revisits nothing, 600 features, 48 keyframe
  and 4096 landmark slots, 60 frames.
- ``kitti_res``: tests/test_e2e_kitti_res.py, 1241x376, fx 718, 900 quads
  5-20 m away, 0.1 m steps, 1000 features, a 10-keyframe local window, 25
  frames.
- ``kitti_turn``: tests/test_e2e_kitti_scale.py::test_e2e_kitti_turn_regime,
  the first 160 frames of tools/kitti_scale_probe.py's 500-frame corridor
  world (forward driving with 90-degree turns, 20 quads a frame step, pixel
  noise 2.0, 8% exposure jitter) at the production budgets: 2000 features,
  4 levels, 256 keyframe and 16384 landmark slots, a 10-keyframe local
  window.

``chip_smoke.py`` tracks each on the card under its test's gates;
tests/test_torch_regimes.py holds each against its test's sequence and
configuration.
"""

from __future__ import annotations

from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence, make_trajectory

# TUM1-magnitude radial-tangential coefficients (k1, k2, p1, p2, k3)
DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
NAMES = ("strafe", "forward", "rotation", "distortion", "no_false_loop", "kitti_res", "kitti_turn")
KITTI_WORLD_FRAMES = 500  # the turn regime's world is built for the whole production run


def _vga(n_features: int, k_max: int, l_max: int, **dist) -> SlamConfig:
    return SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=n_features,
                      n_levels=4, fps=10.0, k_max=k_max, l_max=l_max, **dist)


def kitti_config(n_features: int = 2000, **budgets) -> SlamConfig:
    """KITTI's 1241x376 camera (fx 718) over 4 levels with a 10-keyframe
    local window; the production budgets unless ``budgets`` cut them."""
    return SlamConfig(fx=718.0, fy=718.0, cx=1241 / 2, cy=376 / 2, width=1241, height=376, n_features=n_features,
                      n_levels=4, fps=10.0, local_window=10, **budgets)


def build(name: str) -> tuple[SyntheticSequence, SlamConfig, int]:
    """(sequence, configuration, frames to track) of the regime ``name``."""
    if name in ("strafe", "forward", "rotation"):
        n = 40 if name == "strafe" else 50
        seq = SyntheticSequence(n_frames=n, n_points=700, kind=name, seed=3, noise_sigma=1.0, brightness_jitter=0.1)
        return seq, _vga(1000, 64, 8192), n
    if name == "distortion":
        seq = SyntheticSequence(n_frames=40, n_points=700, kind="strafe", seed=3, dist=DIST)
        k1, k2, p1, p2, k3 = DIST
        return seq, _vga(600, 64, 8192, k1=k1, k2=k2, p1=p1, p2=p2, k3=k3), 40
    if name == "no_false_loop":
        seq = SyntheticSequence(n_frames=60, n_points=700, kind="strafe", seed=11, noise_sigma=1.0,
                                brightness_jitter=0.1)
        return seq, _vga(600, 48, 4096), 60
    if name == "kitti_res":
        seq = SyntheticSequence(n_frames=25, n_points=900, width=1241, height=376, fx=718.0, fy=718.0, kind="strafe",
                                seed=7, depth_range=(5.0, 20.0), spread=(10.0, 4.0), size_range=(0.2, 1.0))
        seq.poses = make_trajectory(seq.n_frames, "strafe", step=0.1)
        return seq, kitti_config(1000, k_max=48, l_max=8192), 25
    if name == "kitti_turn":
        n = KITTI_WORLD_FRAMES
        seq = SyntheticSequence(n_frames=n, n_points=20 * n, width=1241, height=376, fx=718.0, fy=718.0, kind="kitti",
                                step=0.12, seed=3, depth_range=(5.0, 20.0), spread=(10.0, 3.0), size_range=(0.3, 1.2),
                                noise_sigma=2.0, brightness_jitter=0.08)
        return seq, kitti_config(2000), 160
    raise ValueError(f"unknown regime {name!r}; pick from {NAMES}")
