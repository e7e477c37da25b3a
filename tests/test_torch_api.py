"""The port's API against the JAX package's: ``SlamSystem(config, bow_path)``
with the device by keyword, the ``Trackmonocular`` alias, and the tracker's
``cam``, ``new_kf_ids`` and ``last_frame``.

Both packages track the first frames of tests/test_e2e.py's strafe (700
points, seed 3), rendered through tests/test_e2e_distortion.py's TUM1 lens
and run at that test's ``dist_config()``, so each frame's undistorted and
raw coordinates differ. The keyframe slots inserted must be equal, and the
last tracked frame's keypoints as the extractor parity test holds them
(tests/test_torch_extractor.py): octaves equal, level-0 raw coordinates and
validity equal, at least 95% of the other levels' keypoints equal, and the
undistorted coordinates of equal keypoints within 1e-3 px.
"""

import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu.config import SlamConfig as JaxConfig
from orbslam_in_practice_tpu.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu.system import SlamSystem as JaxSystem
from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.slam.tracking import TrackingState
from orbslam_in_practice_tpu_torch.system import SlamSystem

torch.set_num_threads(2)

DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)  # tests/test_e2e_distortion.py
CONFIG = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=600, n_levels=4,
              fps=10.0, k_max=64, l_max=8192, k1=DIST[0], k2=DIST[1], p1=DIST[2], p2=DIST[3], k3=DIST[4])
N_FRAMES = 8  # initialisation, the first unfused frame, then fused frames
XY_TOL = 1e-3  # px, undistorted coordinates of equal keypoints


@pytest.fixture(scope="module")
def runs():
    """(port system, JAX system, per-frame paths of the port) after N_FRAMES."""
    seq = SyntheticSequence(n_frames=N_FRAMES, n_points=700, kind="strafe", seed=3, dist=DIST)
    port = SlamSystem(SlamConfig(**CONFIG), device="cpu")
    ref = JaxSystem(JaxConfig(**CONFIG))
    paths = []
    with torch.no_grad():
        for i in range(N_FRAMES):
            image = seq.render(i)
            port.track_monocular(image, i * 0.1)
            ref.track_monocular(image, i * 0.1)
            paths.append(port.tracker.frame_path)
    return port, ref, paths


def test_bow_path_is_accepted_and_ignored():
    system = SlamSystem(SlamConfig(**CONFIG), "vocab.txt", device="cpu")
    assert system.tracker.device == torch.device("cpu")
    assert system.state == TrackingState.NO_IMAGES
    with pytest.raises(TypeError):
        SlamSystem(SlamConfig(**CONFIG), "vocab.txt", "cpu")  # the device only by keyword


def test_trackmonocular_is_track_monocular():
    assert SlamSystem.Trackmonocular is SlamSystem.track_monocular


def test_fresh_tracker_matches_jax():
    port = SlamSystem(SlamConfig(**CONFIG), device="cpu").tracker
    ref = JaxSystem(JaxConfig(**CONFIG)).tracker
    assert tuple(port.cam) == tuple(ref.cam) and port.cam.has_distortion
    assert port.last_frame is None and ref.last_frame is None
    assert port.new_kf_ids == ref.new_kf_ids == []


def test_new_kf_ids_match_jax(runs):
    port, ref, paths = runs
    assert port.state == TrackingState.OK and ref.state.name == "OK"
    assert "fused" in paths  # the last frames went through the fused step
    assert len(port.tracker.new_kf_ids) > 2
    assert port.tracker.new_kf_ids == ref.tracker.new_kf_ids
    assert port.tracker.new_kf_ids[:2] == [0, 1]
    # the two initial keyframes, then one a local-mapping epoch
    assert len(port.tracker.new_kf_ids) == port.tracker.mapper.n_epochs + 2


def test_last_frame_matches_jax(runs):
    port, ref, paths = runs
    assert paths[-1] == "fused"
    got = {name: getattr(port.tracker.last_frame, name).numpy() for name in ("xy", "xy_raw", "valid", "octave")}
    want = {name: np.asarray(getattr(ref.tracker.last_frame, name)) for name in got}
    assert np.array_equal(got["octave"], want["octave"])
    lvl0 = want["octave"] == 0
    for name in ("xy_raw", "valid"):
        assert np.array_equal(got[name][lvl0], want[name][lvl0]), name
    same = np.all(got["xy_raw"] == want["xy_raw"], axis=-1) & want["valid"] & got["valid"]
    assert same[~lvl0].sum() >= 0.95 * want["valid"][~lvl0].sum()
    assert np.abs(got["xy"] - want["xy"])[same].max() < XY_TOL
    # the lens is on the path: raw and undistorted coordinates differ
    v = got["valid"]
    assert np.abs(got["xy"] - got["xy_raw"])[v].max() > 1.0


def test_reset_keeps_last_frame_and_new_kf_ids(runs):
    """As in the JAX package, ``reset`` clears neither."""
    for system, make in ((runs[0], lambda: SlamSystem(SlamConfig(**CONFIG), device="cpu")),
                         (runs[1], lambda: JaxSystem(JaxConfig(**CONFIG)))):
        tracker = make().tracker
        frame, ids = system.tracker.last_frame, list(system.tracker.new_kf_ids)
        tracker.last_frame, tracker.new_kf_ids = frame, list(ids)
        tracker.reset()
        assert tracker.last_frame is frame and tracker.new_kf_ids == ids
        assert tracker.state.name == "NOT_INITIALIZED"
