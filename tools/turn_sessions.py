"""Whole closed-loop sessions of a benchmark cell on the card, frame by frame.

    python tools/turn_sessions.py [--root CHECKOUT] [--cell kitti00.drive] [--frames 200]
        --seeds S [S ...] --out FILE.jsonl

Each seed is one session from an empty map on a new ``SlamSystem``, on the
frames the benchmark's own generator and renderer make for the cell at that
seed (``portbench/traffic.py::build_sequence``, ``portbench/scene.py``),
as a window's session runs them. For every frame it writes one JSON line:
the tracker's path, whether a pose came back, the fused step's outcome
(``ok1``: the motion model tracked; ``ok``: the local map too; null where
the step did not run), the frame's counters (the match counts, ``inliers``,
``lm_accepted`` where the program records it), the loop closures so far
and the frame's host ms; then one summary line a seed: the first frame with
a pose and the frames lost after it. ``--root`` imports the program and
the harness from another checkout (an older commit unpacked with ``git
archive``), so that two versions run the same sessions. The sessions of
one process run one after another.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _watch_fused_step(tracking_cls) -> None:
    """Keep the fused step's status on the tracker after each call."""
    track = tracking_cls._track_frame_fused

    def watched(self, image):
        out = track(self, image)
        self.last_fused_status = out[0]
        return out

    tracking_cls._track_frame_fused = watched


def run_session(cell, seed: int, n_frames: int, device, out) -> dict:
    import torch

    from orbslam_in_practice_tpu_torch.config import SlamConfig
    from orbslam_in_practice_tpu_torch.system import SlamSystem
    from portbench.scene import TorchRenderer
    from portbench.traffic import build_sequence

    settings = cell.config["settings"]
    seq = build_sequence(cell.mix, settings, seed)
    renderer = TorchRenderer(seq, device)
    frames = [renderer.render(i) for i in range(min(n_frames, seq.n_frames))]
    system = SlamSystem(SlamConfig(**settings), device=device)
    tracker = system.tracker
    first_pose, lost = None, []
    with torch.no_grad():
        for i, img in enumerate(frames):
            tracker.last_fused_status = None
            t0 = time.perf_counter()
            pose = system.track_monocular(img, i / float(settings["fps"]))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ms = (time.perf_counter() - t0) * 1e3
            status = tracker.last_fused_status if tracker.frame_path in ("fused", "fused_fallback") else None
            if pose is not None and first_pose is None:
                first_pose = i
            if pose is None and first_pose is not None:
                lost.append(i)
            lc = tracker.loop_closer
            out.write(json.dumps({
                "seed": seed, "i": i, "path": tracker.frame_path, "pose": pose is not None, "kf": tracker.frame_keyframe,
                "ok1": None if status is None else status != "stage1", "ok": None if status is None else status == "ok",
                "counts": tracker.frame_record["counts"], "closures": 0 if lc is None else lc.n_closures, "ms": ms,
            }) + "\n")
    lc = tracker.loop_closer
    summary = {"seed": seed, "summary": True, "frames": len(frames), "first_pose": first_pose, "lost": lost,
               "closures": [] if lc is None else lc.closures}
    out.write(json.dumps(summary, default=float) + "\n")
    out.flush()
    system.shutdown()
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose program and harness to run")
    ap.add_argument("--cell", default="kitti00.drive")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu to rehearse at a few frames")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("turn_sessions: no CUDA device", file=sys.stderr)
        return 2
    from orbslam_in_practice_tpu_torch.slam.tracking import Tracking
    from portbench.bench import load_cell

    _watch_fused_step(Tracking)
    cell = load_cell(root, args.cell)
    with open(args.out, "w") as out:
        for seed in args.seeds:
            s = run_session(cell, seed, args.frames, device, out)
            print(json.dumps({k: s[k] for k in ("seed", "frames", "first_pose", "lost")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
