"""tests/test_e2e_distortion.py on the port, on the CPU: the 40-frame strafe
rendered through TUM1's radial-tangential lens, tracked by ``SlamSystem`` at
that test's configuration (``regimes.build("distortion")``, which
tests/test_torch_regimes.py holds against the test's own), so the
extractor's undistortion runs on every frame of the whole pipeline. The
test's gates: state OK, more than half the frames tracked and aligned, at
least 2 keyframes and more than 50 landmarks, ATE < 0.05, and the last
tracked frame's undistorted coordinates more than 1 px from its raw ones
somewhere. The JAX side is not run again here: its own test runs it.
"""

import numpy as np
import torch

from orbslam_in_practice_tpu_torch import regimes
from orbslam_in_practice_tpu_torch.io.evaluation import ate_rmse
from orbslam_in_practice_tpu_torch.slam.tracking import TrackingState
from orbslam_in_practice_tpu_torch.system import SlamSystem

torch.set_num_threads(2)


def test_e2e_tracks_with_distortion():
    seq, cfg, n = regimes.build("distortion")
    assert cfg.cam.has_distortion
    system = SlamSystem(cfg, device="cpu")
    with torch.no_grad():
        n_tracked = sum(system.track_monocular(seq.render(i), i * 0.1) is not None for i in range(n))
    assert system.state == TrackingState.OK
    assert n_tracked > n // 2
    stats = system.map.stats()
    assert stats["n_kf"] >= 2
    assert stats["n_lm"] > 50
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), seq.gt_centers())
    assert n_aligned > n // 2
    assert rmse < 0.05
    assert system.tracker.n_fused_frames > 0
    frame = system.tracker.last_frame
    v = frame.valid.numpy()
    delta = np.abs(frame.xy.numpy() - frame.xy_raw.numpy())[v]
    assert delta.max() > 1.0
