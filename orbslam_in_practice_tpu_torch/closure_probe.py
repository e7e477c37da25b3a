"""How far the order of float sums moves a loop closure's correction.

    python -m orbslam_in_practice_tpu_torch.closure_probe [--trials N] [--device cuda|cpu]

Runs tests/test_e2e_long_sequence.py's orbit (``chip_smoke.py``'s
``phase_loop``: 340 frames, 600 features, 48 keyframe slots) until its first
loop closure, and there runs the closure's correction (``close_loop``: the
pose graph, then global BA) on copies of the same map, each time with its
sums in another order and the same arithmetic otherwise:

- ``graph``: the essential graph's edges permuted, so the pose graph's
  J^T W J and gradient sum the edges in another order;
- ``ba``: the map's observations permuted, so global BA's camera and
  landmark blocks sum in another order.

Trial 0 keeps both orders; trials 1..N-1 permute one stage's order with the
trial's seed. Each trial prints one JSON line: the keyframe ATE (Sim(3)-
aligned RMSE of keyframe centres against the truth) before the correction,
after the pose graph and after global BA, and global BA's dropped
observations (a permutation can change which observations beyond a
landmark's budget are dropped). The last line gives each stage's spread
(max - min) over the trials of each variant: a stage whose output spreads
more than its input amplifies the roundoff.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import subprocess
import threading

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.io.evaluation import ate_rmse
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch.optim.ba import adaptive_o_max, count_obs_drops
from orbslam_in_practice_tpu_torch.slam import global_ba as global_ba_mod
from orbslam_in_practice_tpu_torch.slam import loop_closing
from orbslam_in_practice_tpu_torch.system import SlamSystem

ORBIT_FRAMES = 340


def orbit():
    """(sequence, config): tests/test_e2e_long_sequence.py's noisy orbit."""
    seq = SyntheticSequence(
        n_frames=ORBIT_FRAMES, n_points=700, kind="orbit", seed=5, orbit_step=2 * math.pi / 280,
        depth_range=(3.0, 9.0), spread=(6.0, 5.0), noise_sigma=1.0, brightness_jitter=0.1,
    )
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=600, n_levels=4,
                     fps=10.0, k_max=48, l_max=4096)
    return seq, cfg


def clone_map(smap):
    """A deep copy of ``smap`` (its device tables too) with a lock of its own."""
    lock, smap.lock = smap.lock, None
    try:
        snap = copy.deepcopy(smap)
    finally:
        smap.lock = lock
    snap.lock = threading.RLock()
    return snap


def keyframe_ate(smap, gt: np.ndarray) -> float:
    kfs = smap.valid_keyframes_by_seq()
    traj = [(int(smap.kf_frame_id[k]), 0.0, smap.hview("kf_pose")[k].astype(np.float64)) for k in kfs]
    return float(ate_rmse(traj, gt)[0])


def correction_trial(closer, snap, loop: tuple, gt: np.ndarray, variant: str, seed: int) -> dict:
    """``closer.close_loop(*loop)`` on a copy of ``snap``, with the stage
    ``variant`` ("graph" or "ba") summing in the order of permutation
    ``seed`` (0: unpermuted). Returns the keyframe ATE before, after the pose
    graph and after global BA, and global BA's dropped observations."""
    smap = clone_map(snap)
    rng = np.random.default_rng(seed)
    out = {"variant": variant, "seed": seed, "ate_before": keyframe_ate(smap, gt)}
    pose_graph, global_ba = loop_closing.optimize_pose_graph, loop_closing.global_bundle_adjustment

    def graph(S, ei, ej, meas, w, fixed):
        if variant == "graph" and seed:
            p = torch.from_numpy(rng.permutation(ei.shape[0])).to(ei.device)
            ei, ej, meas, w = ei[p], ej[p], meas[p], w[p]
        return pose_graph(S, ei, ej, meas, w, fixed)

    def ba(m, *args, **kwargs):
        out["ate_pose_graph"] = keyframe_ate(m, gt)
        observations_of = m.observations_of

        def permuted(lm_ids):
            kf_idx, feat_idx, which = observations_of(lm_ids)
            if variant == "ba" and seed:
                p = rng.permutation(len(which))
                kf_idx, feat_idx, which = kf_idx[p], feat_idx[p], which[p]
            counts = np.bincount(which.astype(np.int64), minlength=1)
            o_max = adaptive_o_max(int(counts.max()), global_ba_mod.O_MAX, cap=global_ba_mod.O_CAP)
            out["ba_dropped"] = count_obs_drops(which, len(lm_ids), o_max)
            return kf_idx, feat_idx, which

        m.observations_of = permuted
        return global_ba(m, *args, **kwargs)

    loop_closing.optimize_pose_graph, loop_closing.global_bundle_adjustment = graph, ba
    try:
        with torch.no_grad():
            closer.close_loop(smap, *loop)
    finally:
        loop_closing.optimize_pose_graph, loop_closing.global_bundle_adjustment = pose_graph, global_ba
    out["ate_global_ba"] = keyframe_ate(smap, gt)
    return out


class _FirstClosure(Exception):
    pass


def run(trials: int, device: str) -> dict:
    seq, cfg = orbit()
    gt = seq.gt_centers()
    system = SlamSystem(cfg, device=device)
    closer = system.tracker.loop_closer
    found = {}

    def intercept(smap, kf_id, cand, s, R, t):
        found.update(snap=clone_map(smap), loop=(kf_id, cand, s, R, t),
                     frames=(int(smap.kf_frame_id[kf_id]), int(smap.kf_frame_id[cand])))
        raise _FirstClosure

    closer.close_loop = intercept
    frame = 0
    try:
        with torch.no_grad():
            for frame in range(ORBIT_FRAMES):
                system.track_monocular(seq.render(frame), 0.1 * frame)
    except _FirstClosure:
        pass
    del closer.close_loop  # the class's method again
    if not found:
        raise SystemExit(f"closure_probe: no loop closure in {ORBIT_FRAMES} frames")
    print(f"closure_probe: first closure at frame {frame}, keyframe frames {found['frames'][0]} -> "
          f"{found['frames'][1]}", flush=True)
    rows = [correction_trial(closer, found["snap"], found["loop"], gt, "none", 0)]
    print(json.dumps(rows[0]), flush=True)
    for variant in ("graph", "ba"):
        for seed in range(1, trials):
            rows.append(correction_trial(closer, found["snap"], found["loop"], gt, variant, seed))
            print(json.dumps(rows[-1]), flush=True)
    spread = {}
    for variant in ("graph", "ba"):
        sel = [rows[0]] + [r for r in rows if r["variant"] == variant]
        spread[variant] = {k: max(r[k] for r in sel) - min(r[k] for r in sel)
                           for k in ("ate_before", "ate_pose_graph", "ate_global_ba")}
    return {"frame": frame, "keyframe_frames": found["frames"], "trials": trials, "spread": spread}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        print(smi.stdout.strip())
    print(json.dumps(run(args.trials, args.device)))


if __name__ == "__main__":
    main()
