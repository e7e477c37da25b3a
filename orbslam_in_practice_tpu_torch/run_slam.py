"""Run the port's SLAM system end to end on a synthetic sequence or a dataset.

    python -m orbslam_in_practice_tpu_torch.run_slam --synthetic [--frames 60] [--device cuda] [--async-mapping]
    python -m orbslam_in_practice_tpu_torch.run_slam --tum DIR --config configs/TUM1.yaml
    python -m orbslam_in_practice_tpu_torch.run_slam --kitti SEQ_DIR [--kitti-poses POSES] --config configs/KITTI00-02.yaml
    python -m orbslam_in_practice_tpu_torch.run_slam --euroc DIR --config configs/EuRoC.yaml

The counterpart of the JAX package's ``run_slam.py``. ``--synthetic`` is
its strafe sequence (600 points, seed 0) at 640x480, fx = fy = 500, 800
features over 4 levels, 256 keyframe and 16384 landmark slots, loop closing
on (the strafe never revisits a place, so none closes); a dataset runs at
``--config``'s settings (``SlamConfig()``'s without one), with the ATE
against its ground truth where it has some. ``--async-mapping`` runs the
mapping epochs in a worker thread.

Prints milliseconds per frame by the path that tracked it (initialisation,
fused step, fused step then reference-keyframe fallback, unfused flow,
relocalisation), apart for the frames that ran (or queued) a keyframe
epoch, milliseconds per keyframe epoch by stage (the local-mapping stages
and the loop closer's), frames/s, the tracked fraction, loop closures and
the ATE, then one JSON line. ``--traj-out``, ``--map-out``, ``--log`` (one
JSON line a frame, with the spans and counters the frame recorded and the
keyframe epochs finished meanwhile) and ``--viz`` (a PNG of the map) write
files. The
default device is ``cuda``; it runs on the CPU only when ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.config import SlamConfig, load_config
from orbslam_in_practice_tpu_torch.io.evaluation import ate_rmse
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch.slam.local_mapping import STAGES as EPOCH_STAGES
from orbslam_in_practice_tpu_torch.slam.loop_closing import STAGES as LC_STAGES
from orbslam_in_practice_tpu_torch.system import SlamSystem
from orbslam_in_practice_tpu_torch.utils.logging import FrameLog

FRAME_KINDS = ("init", "fused", "fused_fallback", "unfused", "reloc", "reset", "lost")
FRAME_DT = 0.1  # seconds between frames' timestamps


def synthetic_config() -> SlamConfig:
    """The synthetic run's configuration."""
    return SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=800,
                      n_levels=4, k_max=256, l_max=16384)


def run_sequence(system: SlamSystem, seq: SyntheticSequence, n_frames: int, drain_timeout: float | None = None) -> dict:
    """``run_frames`` over frames 0..n_frames-1 of a rendered sequence."""
    frames = ((i * FRAME_DT, seq.render(i)) for i in range(n_frames))
    return run_frames(system, frames, seq.gt_centers()[:n_frames], drain_timeout=drain_timeout)


def run_frames(system: SlamSystem, frames, gt_positions=None, gt_ids=None, flog: FrameLog | None = None,
               drain_timeout: float | None = None) -> dict:
    """Track ``frames``, (timestamp, image) pairs. Each frame is timed by the
    host clock around ``track_monocular`` alone (the device synchronised
    after it; rendering or decoding the frame is not timed) and sorted by
    the path the tracker reports for it (``Tracking.frame_path``; 'lost'
    when a steady-state frame was not tracked), its frames with a keyframe
    epoch apart from those without. With asynchronous mapping the epochs
    queued last are drained after the last frame, timed apart; a drain
    longer than ``drain_timeout`` seconds raises TimeoutError. ``flog``
    gets a line a frame: ``Tracking.frame_record``'s keys among its own,
    and ``epochs``, the records of the keyframe epochs that finished since
    the frame before (``StageTimer.epochs``; a synchronous epoch in its
    own frame's line).

    Returns a dict: per-path frame counts and mean ms (``frame_*`` without
    an epoch, ``keyframe_*`` with one), epoch stage ms (the loop closer's
    stages over the epochs too), the tracked count, fps (frames over the
    seconds inside ``track_monocular``), final state, loop closures, map
    stats, the asynchronous worker's figures (``queue_wait_ms``, the mean
    time an epoch waited in the queue) and, with ground truth
    (positions of the frames ``gt_ids``, default all), the ATE.
    """
    tracker = system.tracker
    device = tracker.device
    driver = tracker.async_driver
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    frame_ms = {k: [] for k in FRAME_KINDS}
    keyframe_ms = {k: [] for k in FRAME_KINDS}
    n_frames, n_tracked, max_pending = 0, 0, 0
    queue_wait_ms = []

    def take_epochs() -> list:
        epochs = tracker.record.take_epochs()
        queue_wait_ms.extend(ep["queue_wait_ms"] for ep in epochs if "queue_wait_ms" in ep)
        return epochs

    sync()
    for ts, img in frames:
        t0 = time.perf_counter()
        pose = system.track_monocular(img, ts)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        n_frames += 1
        n_tracked += pose is not None
        kind = tracker.frame_path
        if pose is None and kind not in ("init", "reset"):
            kind = "lost"
        (keyframe_ms if tracker.frame_keyframe else frame_ms)[kind].append(ms)
        if driver is not None:
            max_pending = max(max_pending, driver.pending())
        epochs = take_epochs()
        if flog is not None:
            flog.log(frame=n_frames - 1, path=kind, keyframe=tracker.frame_keyframe, state=system.state.name,
                     tracked=pose is not None, inliers=tracker.n_inliers, ms=ms, **tracker.frame_record,
                     epochs=epochs, **system.map.stats())
    epochs_overlapped = None if driver is None else driver.n_processed
    t0 = time.perf_counter()
    if not system.wait_idle(drain_timeout):
        raise TimeoutError(f"the mapping worker did not drain within {drain_timeout} s")
    sync()
    drain_ms = (time.perf_counter() - t0) * 1e3
    take_epochs()
    tracked_s = sum(sum(v) for v in (*frame_ms.values(), *keyframe_ms.values())) / 1e3
    mapper = tracker.mapper
    n_epochs = max(mapper.n_epochs, 1)
    rmse = n_aligned = coverage = None
    if gt_positions is not None:
        rmse, n_aligned, coverage = ate_rmse(system.get_trajectory(), gt_positions, gt_ids)
    mean = lambda v: sum(v) / len(v) if v else None  # noqa: E731
    stage_s = {k: mapper.stage_s.get(k, 0.0) for k in EPOCH_STAGES}
    closer = tracker.loop_closer
    if closer is not None:
        stage_s.update({k: closer.stage_s.get(k, 0.0) for k in LC_STAGES})
    return {
        "frames": n_frames,
        "tracked": n_tracked,
        "tracked_fraction": n_tracked / max(n_frames, 1),
        "fps": n_frames / tracked_s,
        "state": system.state.name,
        "frame_count": {k: len(v) for k, v in frame_ms.items()},
        "frame_ms": {k: mean(v) for k, v in frame_ms.items()},
        "keyframe_count": {k: len(v) for k, v in keyframe_ms.items()},
        "keyframe_ms": {k: mean(v) for k, v in keyframe_ms.items()},
        "epochs": mapper.n_epochs,
        "epoch_stage_ms": {k: v * 1e3 / n_epochs for k, v in stage_s.items()},
        "async_mapping": driver is not None,
        "epochs_done_while_tracking": epochs_overlapped,
        "max_pending": max_pending if driver is not None else None,
        "drain_ms": drain_ms,
        "queue_wait_ms": mean(queue_wait_ms) if driver is not None else None,
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
    ap.add_argument("--synthetic", action="store_true", help="the rendered synthetic sequence")
    ap.add_argument("--tum", default=None, help="TUM RGB-D sequence directory")
    ap.add_argument("--kitti", default=None, help="KITTI odometry sequence directory")
    ap.add_argument("--kitti-poses", default=None, help="KITTI ground-truth poses file")
    ap.add_argument("--euroc", default=None, help="EuRoC MAV sequence directory")
    ap.add_argument("--config", default=None, help="ORB-SLAM style YAML settings of a dataset")
    ap.add_argument("--frames", type=int, default=0, help="at most this many frames (0: all; synthetic: 60)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--async-mapping", action="store_true", help="run the mapping epochs in a worker thread")
    ap.add_argument("--traj-out", default=None, help="write the TUM trajectory here")
    ap.add_argument("--map-out", default=None, help="write the map checkpoint (.npz) here")
    ap.add_argument("--log", default=None, help="append one JSON line a frame here")
    ap.add_argument("--viz", default=None, help="render the map and trajectory to this PNG")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_slam: no CUDA device (pass --device cpu to run on the CPU)")

    gt_ids = None
    if args.synthetic:
        n = args.frames or 60
        seq = SyntheticSequence(n_frames=n)
        cfg = synthetic_config()
        frames = ((i * FRAME_DT, seq.render(i)) for i in range(n))
        gt_positions = seq.gt_centers()
    else:
        from orbslam_in_practice_tpu_torch.io import datasets

        if args.tum:
            ds = datasets.load_tum(args.tum)
        elif args.kitti:
            ds = datasets.load_kitti(args.kitti, args.kitti_poses)
        elif args.euroc:
            ds = datasets.load_euroc(args.euroc)
        else:
            ap.error("pick --synthetic, --tum, --kitti or --euroc")
        cfg = load_config(args.config) if args.config else SlamConfig()
        frames = ds.frames()
        if args.frames:
            frames = (f for _, f in zip(range(args.frames), frames))
        gt_ids, gt_positions = ds.gt_positions_for_frames()
    if args.async_mapping:
        cfg = dataclasses.replace(cfg, async_mapping=True)

    system = SlamSystem(cfg, device=device)
    with torch.no_grad():
        out = run_frames(system, frames, gt_positions, gt_ids, FrameLog(args.log) if args.log else None)
    out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for kind in FRAME_KINDS:
        for what, n, ms in (("frames", out["frame_count"][kind], out["frame_ms"][kind]),
                            ("keyframe frames", out["keyframe_count"][kind], out["keyframe_ms"][kind])):
            if n:
                print(f"{kind} {what}: {n}, {ms:.1f} ms/frame")
    print(f"keyframe epochs: {out['epochs']}, ms/epoch by stage: "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["epoch_stage_ms"].items()))
    if out["async_mapping"]:
        print(f"async mapping: {out['epochs_done_while_tracking']} epochs done while tracking went on, at most "
              f"{out['max_pending']} pending, drain after the last frame {out['drain_ms']:.1f} ms, "
              f"{out['queue_wait_ms'] or 0.0:.1f} ms in the queue an epoch")
    ate = "no ground truth" if out["ate_rmse"] is None else f"ATE {out['ate_rmse']:.5f}"
    print(f"{out['fps']:.2f} frames/s, tracked {out['tracked']}/{out['frames']}, {ate}, {out['n_kf']} keyframes, "
          f"{out['n_lm']} landmarks, {out['loop_closures']} loop closures, on {out['device']}")
    if args.traj_out:
        system.save_trajectory_tum(args.traj_out)
    if args.map_out:
        system.save_map(args.map_out)
    if args.viz:
        from orbslam_in_practice_tpu_torch.utils.viewer import render_map

        centers = [-(T[:3, :3].T @ T[:3, 3]) for _, _, T in system.get_trajectory() if T is not None]
        render_map(system.map, args.viz, trajectory=np.asarray(centers) if centers else None,
                   title=f"{out['frames']} frames, {out['n_lm']} landmarks")
        out["viz"] = args.viz
    system.shutdown()
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
