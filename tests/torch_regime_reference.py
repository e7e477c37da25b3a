"""The JAX package's figures on the end-to-end regimes that ``chip_smoke.py``
holds the port to, on the CPU.

    python tests/torch_regime_reference.py [RUN ...]

RUN is any of strafe, forward, rotation (tests/test_e2e_motion_regimes.py),
distortion (tests/test_e2e_distortion.py), no_false_loop
(tests/test_e2e_long_sequence.py::test_no_false_loop_closures_without_revisit),
kitti_res (tests/test_e2e_kitti_res.py) and kitti_turn
(tests/test_e2e_kitti_scale.py::test_e2e_kitti_turn_regime); all of them
when none is given. Each run uses its test's own sequence and configuration
(imported from the test, or from tools/kitti_scale_probe.py) and prints one
JSON line: frames, tracked, aligned, ATE, keyframes, landmarks, loop
closures (with the latest one's keyframe frames and their true distance)
and seconds; the KITTI turn also its path length, longest untracked run
and local-BA truncations. The constants at the top of
``chip_smoke.py`` come from this script.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

RUNS = ("strafe", "forward", "rotation", "distortion", "no_false_loop", "kitti_res", "kitti_turn")


def build(name: str):
    """(sequence, config, frames) of one regime, as its JAX test builds them."""
    from orbslam_in_practice_tpu.config import SlamConfig
    from orbslam_in_practice_tpu.io.synthetic import SyntheticSequence, make_trajectory

    if name in ("strafe", "forward", "rotation"):
        from tests.test_e2e_motion_regimes import _config

        n = 40 if name == "strafe" else 50
        seq = SyntheticSequence(n_frames=n, n_points=700, kind=name, seed=3, noise_sigma=1.0, brightness_jitter=0.1)
        return seq, _config(1000), n
    if name == "distortion":
        from tests.test_e2e_distortion import DIST, dist_config

        return SyntheticSequence(n_frames=40, n_points=700, kind="strafe", seed=3, dist=DIST), dist_config(), 40
    if name == "no_false_loop":
        from tests.test_e2e_long_sequence import _config

        seq = SyntheticSequence(n_frames=60, n_points=700, kind="strafe", seed=11, noise_sigma=1.0,
                                brightness_jitter=0.1)
        return seq, _config(), 60
    if name == "kitti_res":
        seq = SyntheticSequence(n_frames=25, n_points=900, width=1241, height=376, fx=718.0, fy=718.0, kind="strafe",
                                seed=7, depth_range=(5.0, 20.0), spread=(10.0, 4.0), size_range=(0.2, 1.0))
        seq.poses = make_trajectory(seq.n_frames, "strafe", step=0.1)
        cfg = SlamConfig(fx=718.0, fy=718.0, cx=1241 / 2, cy=376 / 2, width=1241, height=376, n_features=1000,
                         n_levels=4, fps=10.0, k_max=48, l_max=8192, local_window=10)
        return seq, cfg, 25
    if name == "kitti_turn":
        from tools.kitti_scale_probe import build as kitti_build

        seq, cfg = kitti_build(500)
        return seq, cfg, 160
    raise ValueError(f"unknown run {name!r}; pick from {RUNS}")


def run(name: str) -> dict:
    from orbslam_in_practice_tpu.io.evaluation import ate_rmse
    from orbslam_in_practice_tpu.slam.tracking import TrackingState
    from orbslam_in_practice_tpu.system import SlamSystem

    seq, cfg, n = build(name)
    t0 = time.perf_counter()
    system = SlamSystem(cfg)
    n_tracked = n_ok = lost_run = cur = 0
    for i in range(n):
        pose = system.track_monocular(seq.render(i), i * 0.1)
        n_tracked += pose is not None
        if pose is not None and system.state == TrackingState.OK:
            n_ok += 1
            cur = 0
        else:
            cur += 1
            lost_run = max(lost_run, cur)
    gt = seq.gt_centers()[:n]
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), gt)
    stats = system.map.stats()
    closer = system.tracker.loop_closer
    out = {
        "run": name, "frames": n, "tracked": n_tracked, "tracked_ok": n_ok, "aligned": int(n_aligned),
        "ate": float(rmse), "n_kf": int(stats["n_kf"]), "n_lm": int(stats["n_lm"]),
        "closures": 0 if closer is None else closer.n_closures,
        "state": system.state.name, "seconds": time.perf_counter() - t0,
    }
    if closer is not None and closer.last_closure is not None:
        # the latest closure: the frames of its two keyframes, and how far
        # apart their true camera centres are (a revisit brings them close)
        kf, cand = (int(system.map.kf_frame_id[k]) for k in closer.last_closure)
        out["last_closure_frames"] = [kf, cand]
        out["last_closure_true_distance"] = float(np.linalg.norm(gt[kf] - gt[cand]))
    if name == "kitti_turn":
        path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
        out.update(path=path, ate_pct_of_path=100.0 * float(rmse) / path, longest_lost_run=lost_run,
                   n_ba_truncations=system.tracker.mapper.stats()["n_ba_truncations"])
    return out


if __name__ == "__main__":
    for name in sys.argv[1:] or RUNS:
        print(json.dumps(run(name)), flush=True)
