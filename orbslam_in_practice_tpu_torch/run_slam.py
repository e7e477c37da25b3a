"""Run the port's SLAM system end to end on a rendered synthetic sequence.

    python -m orbslam_in_practice_tpu_torch.run_slam --synthetic [--frames 60] [--device cuda]

The counterpart of the JAX package's ``run_slam.py --synthetic``: the strafe
sequence (600 points, seed 0) at 640x480, fx = fy = 500, 800 features over
4 levels, 256 keyframe and 16384 landmark slots, loop closing on (the
strafe never revisits a place, so none closes). Prints milliseconds per
frame by the path that tracked it (initialisation, fused step, fused step
then reference-keyframe fallback, unfused flow, relocalisation), apart for
the frames that ran a keyframe epoch, milliseconds per keyframe epoch by
stage (the local-mapping stages and the loop closer's), frames/s, the
tracked fraction, loop closures and the ATE, then one JSON line.
The default device is ``cuda``; it runs on the CPU only when ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.io.evaluation import ate_rmse
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch.slam.loop_closing import STAGES as LC_STAGES
from orbslam_in_practice_tpu_torch.system import SlamSystem

EPOCH_STAGES = ("kf_create", "kf_fuse", "kf_local_ba", "kf_cull", "kf_refresh")
FRAME_KINDS = ("init", "fused", "fused_fallback", "unfused", "reloc", "reset", "lost")
FRAME_DT = 0.1  # seconds between frames' timestamps


def synthetic_config() -> SlamConfig:
    """The synthetic run's configuration."""
    return SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=800,
                      n_levels=4, k_max=256, l_max=16384)


def run_sequence(system: SlamSystem, seq: SyntheticSequence, n_frames: int) -> dict:
    """Track frames 0..n_frames-1 of ``seq``. Each frame is timed by the
    host clock around ``track_monocular`` alone (the device synchronised
    after it; rendering the frame is not timed) and sorted by the path the
    tracker reports for it (``Tracking.frame_path``; 'lost' when a
    steady-state frame was not tracked), its frames with a keyframe epoch
    apart from those without.

    Returns a dict: per-path frame counts and mean ms (``frame_*`` without
    an epoch, ``keyframe_*`` with one), epoch stage ms (the loop closer's
    stages over the epochs too), the tracked count, fps (frames over the
    seconds inside ``track_monocular``), final state, loop closures, map
    stats and ATE.
    """
    tracker = system.tracker
    device = tracker.device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    frame_ms = {k: [] for k in FRAME_KINDS}
    keyframe_ms = {k: [] for k in FRAME_KINDS}
    n_tracked = 0
    sync()
    for i in range(n_frames):
        img = seq.render(i)
        t0 = time.perf_counter()
        pose = system.track_monocular(img, i * FRAME_DT)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        n_tracked += pose is not None
        kind = tracker.frame_path
        if pose is None and kind not in ("init", "reset"):
            kind = "lost"
        (keyframe_ms if tracker.frame_keyframe else frame_ms)[kind].append(ms)
    tracked_s = sum(sum(v) for v in (*frame_ms.values(), *keyframe_ms.values())) / 1e3
    mapper = tracker.mapper
    n_epochs = max(mapper.n_epochs, 1)
    rmse, n_aligned, coverage = ate_rmse(system.get_trajectory(), seq.gt_centers()[:n_frames])
    mean = lambda v: sum(v) / len(v) if v else None  # noqa: E731
    stage_s = {k: mapper.stage_s.get(k, 0.0) for k in EPOCH_STAGES}
    closer = tracker.loop_closer
    if closer is not None:
        stage_s.update({k: closer.stage_s.get(k, 0.0) for k in LC_STAGES})
    return {
        "frames": n_frames,
        "tracked": n_tracked,
        "tracked_fraction": n_tracked / n_frames,
        "fps": n_frames / tracked_s,
        "state": system.state.name,
        "frame_count": {k: len(v) for k, v in frame_ms.items()},
        "frame_ms": {k: mean(v) for k, v in frame_ms.items()},
        "keyframe_count": {k: len(v) for k, v in keyframe_ms.items()},
        "keyframe_ms": {k: mean(v) for k, v in keyframe_ms.items()},
        "epochs": mapper.n_epochs,
        "epoch_stage_ms": {k: v * 1e3 / n_epochs for k, v in stage_s.items()},
        "loop_closures": 0 if closer is None else closer.n_closures,
        "closures": [] if closer is None else closer.closures,
        "fused_frames": tracker.n_fused_frames,
        "local_map_truncations": tracker.n_local_map_truncations,
        **mapper.stats(),
        "ate_rmse": rmse,
        "aligned_frames": n_aligned,
        "coverage": coverage,
        **system.map.stats(),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--synthetic", action="store_true", required=True, help="the rendered synthetic sequence")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--traj-out", default=None, help="write the TUM trajectory here")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_slam: no CUDA device (pass --device cpu to run on the CPU)")

    seq = SyntheticSequence(n_frames=args.frames)
    system = SlamSystem(synthetic_config(), device=device)
    out = run_sequence(system, seq, args.frames)
    out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for kind in FRAME_KINDS:
        for what, n, ms in (("frames", out["frame_count"][kind], out["frame_ms"][kind]),
                            ("keyframe frames", out["keyframe_count"][kind], out["keyframe_ms"][kind])):
            if n:
                print(f"{kind} {what}: {n}, {ms:.1f} ms/frame")
    print(f"keyframe epochs: {out['epochs']}, ms/epoch by stage: "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["epoch_stage_ms"].items()))
    print(f"{out['fps']:.2f} frames/s, tracked {out['tracked']}/{out['frames']}, "
          f"ATE {out['ate_rmse']:.5f}, {out['n_kf']} keyframes, {out['n_lm']} landmarks, "
          f"{out['loop_closures']} loop closures, on {out['device']}")
    if args.traj_out:
        system.save_trajectory_tum(args.traj_out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
