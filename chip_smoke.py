#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``orbslam_in_practice_tpu_torch`` from
``csrc/``, checks each against its plain PyTorch version on the card in
one launch over every pyramid level, at the shapes the extractors give it
(kernel A at the bench frame's 4 levels, a TUM1 frame's 8 and a KITTI
frame's 4; kernel B at 512, 800, 1000 and 1600 keypoints over the 4 bench
levels, 1000 over TUM1's 8, and 1000 and 2000 over KITTI's 4), and prints
its device time beside its bound. It runs the TUM1
extractor (1000 features, 8 levels, radtan distortion), then drives the fused steady-state tracking
step over 10 rendered frames of the benchmark scene (640x480, 512 features,
4 levels, 16384 landmark slots) with the kernels and with the plain path,
feeding pose and velocity forward. Then it runs the whole system,
``SlamSystem``, three times, at the JAX package's default settings (loop
closing on, relocalisation when lost):

- ``phase_system``: the 60-frame synthetic strafe from its first frame
  (``python -m orbslam_in_practice_tpu_torch.run_slam --synthetic``'s
  configuration: 800 features, 4 levels, 256 keyframe and 16384 landmark
  slots): initialisation, tracking, local mapping, loop detection (the
  strafe revisits nothing: no closure), and the ATE against the JAX
  package's figures;
- ``phase_relocalize``: the same configuration on tests/test_e2e.py's
  kidnapped camera: 28 frames, 3 blank frames (LOST), frame 20 again
  (relocalised near its earlier pose), frame 21 (tracked);
- ``phase_loop``: tests/test_e2e_long_sequence.py's live loop closure, a
  340-frame noisy orbit against 48 keyframe slots: tracked, slots recycled,
  at least one closure, ATE after < 0.6 of the ATE just before the first
  closure and < 1% of the path;
- ``phase_async``: ``phase_system``'s run with ``async_mapping=True``, the
  mapping epochs in a worker thread: tracked, ATE, closures, the queue
  throttle, the drain and the worker's shutdown; frames/s beside
  ``phase_system``'s;
- ``phase_dist_ba``: distributed BA over 8 landmark shards in a one-rank
  NCCL process group (a TCPStore on 127.0.0.1): tests/test_dist_ba.py's
  problem against the same call on the CPU without a group and against the
  truth, then ``distributed_global_ba`` on ``phase_system``'s final map
  (its cost must not rise);
- ``phase_dataset``: the strafe's first 20 frames written as 8-bit PGM in a
  TUM layout, read back with ``load_tum`` (the native loader, built in this
  run; its prefetch queue against ``read_image``) and tracked:
  tests/test_e2e_real_data_glue.py's gates;
- the JAX package's other end-to-end regimes (``regimes.py``), each under
  its test's gates, with the JAX package's figures beside the port's:
  ``phase_regimes`` (tests/test_e2e_motion_regimes.py: noisy strafe, forward
  and rotation-dominant motion at 1000 features), ``phase_distortion``
  (tests/test_e2e_distortion.py: TUM1's lens on every frame),
  ``phase_no_false_loop`` (tests/test_e2e_long_sequence.py's strafe that
  revisits nothing: no closure), ``phase_kitti_res``
  (tests/test_e2e_kitti_res.py: 1241x376 at 1000 features) and
  ``phase_kitti_turn`` (tests/test_e2e_kitti_scale.py's turn regime: 160
  frames of the corridor world through its first 90-degree turn at 2000
  features and the production budgets).

In every system run each kernel must launch once per extraction. It prints
times in microseconds per kernel launch and milliseconds per frame, per
keyframe epoch and per loop closure by span, one JSON line describing the
kernels (launches summed over the tracking step's and every system run),
and last ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero; without a CUDA device
it exits 2 and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# camera-centre error (scene units) of the JAX package's fused step on these
# 10 frames, fed the same state, as tests/test_torch_step.py measures it on
# the CPU; the port must stay under twice it on each frame. The strafe step
# is 0.04 units.
REFERENCE_CENTRE_ERR = (0.00459, 0.00880, 0.00735, 0.00535, 0.00585, 0.00477, 0.00726, 0.00980, 0.01013, 0.01569)
# the JAX package's SlamSystem on the same 60 frames and configuration, loop
# closing on, on the CPU (measured again with loop closing on; the figures
# equal those with it off): 58 of 60 frames tracked, ATE 0.015822 in scene
# units, 14 keyframes, 1322 landmarks, 0 loop closures. The port must track
# at least 2 frames fewer, stay under twice that ATE or tests/test_e2e.py's
# 0.05, and close as many loops.
REFERENCE_SYSTEM_TRACKED = 58
REFERENCE_SYSTEM_ATE = 0.015822
REFERENCE_SYSTEM_CLOSURES = 0
SYSTEM_FRAMES = 60
# the JAX package's SlamSystem on the same 60 frames with async_mapping=True,
# on the CPU, twice: 58 tracked both times, ATE 0.016642 and 0.010680 (the
# worker's timing varies), 9 keyframes, 0 closures. The port's async run
# must track at least 80% of the frames and stay under twice the larger ATE
# or 0.05.
REFERENCE_ASYNC_ATE = 0.016642
ASYNC_MIN_TRACKED = 48
# tests/test_dist_ba.py: its problem (seed 0, 6 cameras, 256 landmarks) over
# 8 shards, 15 LM iterations; its gates against the truth, and the card
# against the CPU
DIST_SHARDS, DIST_ITERATIONS = 8, 15
DIST_POSE_TRUTH_TOL, DIST_POINT_TRUTH_TOL, DIST_CARD_TOL = 5e-3, 3e-2, 1e-4
# tests/test_e2e_real_data_glue.py's TUM layout and gates
DATASET_FRAMES, DATASET_MIN_TRACKED, DATASET_MIN_ALIGNED, DATASET_ATE = 20, 15, 10, 0.10
# tests/test_e2e.py::test_e2e_lost_and_relocalize's gates on the recovered
# pose against the port's own estimate of the same frame
RELOC_TRACK_FRAMES, RELOC_FRAME = 28, 20
RELOC_T_TOL, RELOC_R_TOL = 0.06, 0.05
# the JAX package's SlamSystem on the end-to-end regimes of regimes.py, on
# the CPU (tests/torch_regime_reference.py): frames tracked, aligned, ATE
# (scene units), keyframes, landmarks, loop closures; the KITTI turn also its
# frames tracked in state OK, longest untracked run and ATE in % of the
# path. Printed beside the port's; the gates are the JAX tests' own bounds
# (REGIME_GATES), and a port ATE above twice the JAX package's is flagged.
REFERENCE_REGIMES = {
    "strafe": dict(tracked=38, aligned=38, ate=0.009329, n_kf=11, n_lm=1014, closures=0),
    "forward": dict(tracked=42, aligned=42, ate=0.008394, n_kf=17, n_lm=1040, closures=0),
    "rotation": dict(tracked=47, aligned=47, ate=0.029534, n_kf=16, n_lm=1191, closures=0),
    "distortion": dict(tracked=38, aligned=38, ate=0.019597, n_kf=17, n_lm=967, closures=0),
    "no_false_loop": dict(tracked=58, aligned=58, ate=0.013131, n_kf=12, n_lm=804, closures=0),
    "kitti_res": dict(tracked=24, aligned=24, ate=0.031519, n_kf=17, n_lm=1904, closures=0),
    "kitti_turn": dict(tracked=152, aligned=152, ate=0.035283, n_kf=84, n_lm=8836, closures=1, tracked_ok=152,
                       lost_run=7, ate_pct=0.184131),
}
# the JAX tests' gates: tracked and aligned above, ATE below
REGIME_GATES = {
    "strafe": dict(tracked=30, aligned=30, ate=0.02),
    "forward": dict(tracked=25, ate=0.05),
    "rotation": dict(tracked=25, ate=0.05),
    "distortion": dict(tracked=20, aligned=20, ate=0.05),
    "kitti_res": dict(tracked=12, aligned=12, ate=0.08),
}
DISTORTION_MIN_KF, DISTORTION_MIN_LM, DISTORTION_MIN_SHIFT = 2, 50, 1.0  # >=, >, > px
# test_e2e_kitti_turn_regime: tracked in state OK above 90% of the frames, no
# untracked run of 20 frames, ATE under 1.5% of the path, no local-BA clip
TURN_MIN_OK_FRACTION, TURN_MAX_LOST_RUN, TURN_MAX_ATE_PCT = 0.9, 20, 1.5
RENDER_WORKERS = 3  # processes rendering a regime's frames ahead of the tracker
LOOP_FRAMES = 340  # tests/test_e2e_long_sequence.py's orbit
LOOP_K_MAX, LOOP_L_MAX = 48, 4096
ANGLE_TOL = 1e-3  # rad, kernel B vs its plain version
BIT_TOL = 0.005  # fraction of descriptor bits, kernel B vs its plain version
POSE_TOL = 1e-3  # Tcw entries, kernel path vs plain path


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def reset_launches() -> None:
    from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms
    from orbslam_in_practice_tpu_torch.ops.cuda_patch import orb_patch_features

    fast_score_nms.launches = 0
    orb_patch_features.launches = 0


def read_launches() -> dict:
    from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms
    from orbslam_in_practice_tpu_torch.ops.cuda_patch import orb_patch_features

    return {"fast_score_nms": fast_score_nms.launches, "orb_patch_features": orb_patch_features.launches}


def check_launches(launches: dict, calls: list, what: str, n_frames: int) -> None:
    for name, count in launches.items():
        check(count == len(calls) >= n_frames, f"{what} launched {name} {count} times for {len(calls)} extractions "
              f"of {n_frames} frames")


def extraction_counter(*extractors) -> list:
    """A list that grows by one at every call of any of ``extractors``."""
    calls = []
    for extractor in extractors:
        extractor.register_forward_hook(lambda *_: calls.append(1))
    return calls


def phase_fast(device) -> dict:
    """Kernel A in one launch over every pyramid level (the bench frame's 4,
    a TUM1 frame's 8, a KITTI frame's 4) and over one 1241x376 KITTI-size
    frame, against nms3x3(fast_score) on the card: bit-exact. Times at the
    bench levels."""
    import torch

    from orbslam_in_practice_tpu_torch.bench_kernels import (
        bench_levels, bound, events_ms, fast_work, kitti_levels, launch_ms, profiled_ms, tum1_levels,
    )
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.ops.cuda_fast import (
        fast_score_nms, fast_score_nms_levels, fast_score_nms_levels_plain,
    )

    kitti = SyntheticSequence(n_frames=2, n_points=900, width=1241, height=376, seed=1)
    cases = [("bench 4 levels", bench_levels(device)), ("TUM1 8 levels", tum1_levels(device)),
             ("KITTI 1 level", [torch.from_numpy(kitti.render(1)).to(device)]), ("KITTI 4 levels", kitti_levels(device))]
    out = {}
    err = 0.0
    for label, levels in cases:
        before = fast_score_nms.launches
        got = fast_score_nms_levels(levels)
        torch.cuda.synchronize()
        check(fast_score_nms.launches == before + 1, f"kernel A took more than one launch for {label}")
        want = fast_score_nms_levels_plain(levels)
        for g, w in zip(got, want):
            err = max(err, float((g - w).abs().max()))
            check(torch.equal(g, w), f"kernel A differs from its plain version at {tuple(w.shape)}, {label}")
            check(int((w > 0).sum()) > 30, f"too few FAST maxima at {tuple(w.shape)}, {label}")
        k = profiled_ms(lambda: fast_score_nms_levels(levels), "fast_score_nms_kernel")
        ev = launch_ms(lambda: fast_score_nms_levels(levels))
        k = k if math.isfinite(k) else ev  # the profiler saw no kernel: events instead
        wrap = events_ms(lambda: fast_score_nms_levels(levels), 200)
        p = events_ms(lambda: fast_score_nms_levels_plain(levels), 20)
        b_ms, b_by = bound(*fast_work(levels))
        print(f"kernel A fast_score_nms_levels, {label} {[tuple(i.shape) for i in levels]}: one launch, "
              f"device {k * 1e3:.2f} us (events around it {ev * 1e3:.2f}), wrapper {wrap * 1e3:.2f} us/call, "
              f"plain {p * 1e3:.1f} us, "
              f"bound {b_ms * 1e3:.2f} us by {b_by} ({b_ms / k:.0%} of it), bit-exact")
        if not out:
            out = {"ms": k, "plain_ms": p, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return {"max_abs_err": err, **out}


def phase_patch(device, label: str, levels: list, n_features: int) -> dict:
    """Kernel B in one launch over the keypoints of every level, against
    ic_angle + gaussian_blur7 + brief_descriptors + unpack_to_pm1 on the
    card, at the real keypoints of ``n_features`` over ``levels``: angles
    within ANGLE_TOL, bits within BIT_TOL, the ±1 rows equal to the
    kernel's own words unpacked."""
    import torch

    from orbslam_in_practice_tpu_torch.bench_kernels import (
        bound, events_ms, keypoints, launch_ms, patch_work, profiled_ms,
    )
    from orbslam_in_practice_tpu_torch.ops.cuda_patch import (
        orb_patch_features, orb_patch_features_levels, orb_patch_features_levels_plain,
    )
    from orbslam_in_practice_tpu_torch.ops.hamming import unpack_bits, unpack_to_pm1
    from orbslam_in_practice_tpu_torch.ops.orb import orb_pattern

    yx, start, valid = keypoints(levels, n_features)
    pattern = orb_pattern(device)
    before = orb_patch_features.launches
    ang_k, desc_k, pm1_k = orb_patch_features_levels(levels, yx, start, pattern)
    torch.cuda.synchronize()
    check(orb_patch_features.launches == before + 1, f"kernel B took more than one launch for {label}")
    ang_p, desc_p, _ = orb_patch_features_levels_plain(levels, yx, start, pattern)
    check(bool(torch.isfinite(ang_k).all()), "kernel B angle not finite")
    check(torch.equal(pm1_k, unpack_to_pm1(desc_k)), f"kernel B's +-1 rows are not its words unpacked, {label}")
    v = valid
    d = torch.remainder(ang_k[v] - ang_p[v] + math.pi, 2 * math.pi) - math.pi
    err = float(d.abs().max())
    bits = float((unpack_bits(desc_k[v]) != unpack_bits(desc_p[v])).float().mean())
    check(err < ANGLE_TOL, f"kernel B angle error {err}, {label}")
    check(bits < BIT_TOL, f"kernel B bit mismatch {bits}, {label}")
    n = yx.shape[0]
    k = profiled_ms(lambda: orb_patch_features_levels(levels, yx, start, pattern), "orb_patch_kernel")
    ev = launch_ms(lambda: orb_patch_features_levels(levels, yx, start, pattern))
    k = k if math.isfinite(k) else ev  # the profiler saw no kernel: events instead
    wrap = events_ms(lambda: orb_patch_features_levels(levels, yx, start, pattern), 200)
    p = events_ms(lambda: orb_patch_features_levels_plain(levels, yx, start, pattern), 20)
    b_ms, b_by = bound(*patch_work(levels, n))
    print(
        f"kernel B orb_patch_features_levels, {label}: {n} keypoints ({int(v.sum())} valid) in one launch, "
        f"device {k * 1e3:.2f} us (events around it {ev * 1e3:.2f}), wrapper {wrap * 1e3:.2f} us/call, "
        f"plain {p * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us by {b_by} ({b_ms / k:.0%} of it), angle err {err:.3g} rad "
        f"(tolerance {ANGLE_TOL}), bit mismatch {bits:.4%} (tolerance {BIT_TOL:.1%}), +-1 rows exact"
    )
    return {"max_abs_err": err, "ms": k, "plain_ms": p, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_tum1(device) -> None:
    """The TUM1 extractor (1000 features, 8 levels, distortion) on a
    rendered, distorted frame: one launch of each kernel, kernel path finite
    and equal to the plain path's keypoints at level 0."""
    import torch

    from orbslam_in_practice_tpu_torch.bench_kernels import tum1_config, tum1_image
    from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor
    from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms
    from orbslam_in_practice_tpu_torch.ops.cuda_patch import orb_patch_features

    cfg = tum1_config()
    img = tum1_image(device)
    args = (cfg.n_features, cfg.scale_factor, cfg.n_levels, cfg.ini_th_fast, cfg.min_th_fast)
    before = fast_score_nms.launches, orb_patch_features.launches
    fk = ORBExtractor(*args, cam=cfg.cam).to(device)(img)
    check((fast_score_nms.launches, orb_patch_features.launches) == (before[0] + 1, before[1] + 1),
          "the TUM1 extractor did not launch each kernel exactly once")
    fp = ORBExtractor(*args, cam=cfg.cam, use_kernels=False).to(device)(img)
    for name in ("xy", "xy_raw", "angle", "response"):
        check(bool(torch.isfinite(getattr(fk, name)).all()), f"TUM1 {name} not finite")
    lvl0 = fk.octave == 0
    check(torch.equal(fk.valid, fp.valid), "TUM1 validity differs between kernel and plain paths")
    check(torch.equal(fk.xy_raw[lvl0], fp.xy_raw[lvl0]), "TUM1 level-0 keypoints differ")
    check(torch.equal(fk.xy[lvl0], fp.xy[lvl0]), "TUM1 level-0 undistorted keypoints differ")
    n_valid = int(fk.valid.sum())
    check(n_valid > 500, f"TUM1 extractor found only {n_valid} keypoints")
    print(f"TUM1 extractor: {fk.n_features} slots over {cfg.n_levels} levels, {n_valid} valid, one launch of "
          "each kernel, level-0 keypoints equal on both paths")


def run_chain(step, args, images, device):
    """Track frames 1..N, feeding pose and velocity forward. Returns the
    list of (Tcw, ok) per frame, on the host."""
    import torch

    image, packed, velocity, pose, *tables = args
    out = []
    for img in images:
        res = step(torch.from_numpy(img).to(device), packed, velocity, pose, *tables)
        pose, velocity = res[1], res[3]
        out.append((res[1], res[5]))
    return [(T.cpu(), bool(ok)) for T, ok in out]


def phase_step(device) -> dict:
    """The fused step over 10 rendered frames, kernel path and plain path."""
    import numpy as np
    import torch

    from orbslam_in_practice_tpu_torch.bench_state import bench_config, build_bench_state
    from orbslam_in_practice_tpu_torch.slam.tracking import FusedSteadyStep

    cfg = bench_config()
    step, args, images, seq = build_bench_state(cfg, n_images=len(REFERENCE_CENTRE_ERR), device=device)
    plain = FusedSteadyStep(cfg, use_kernels=False).to(device)
    calls = extraction_counter(step.extractor)

    with torch.no_grad():
        reset_launches()
        tracked = run_chain(step, args, images, device)
        launches = read_launches()
        tracked_plain = run_chain(plain, args, images, device)
    for name, n in launches.items():
        check(n == len(calls) == len(images), f"the tracking step launched {name} {n} times for {len(calls)} "
              f"extractions of {len(images)} frames")

    errs = []
    for i, ((T, ok), (Tp, okp)) in enumerate(zip(tracked, tracked_plain)):
        gt = seq.poses[1 + i]
        centre = -(T[:3, :3].T @ T[:3, 3]).numpy()
        err = float(np.linalg.norm(centre - (-(gt[:3, :3].T @ gt[:3, 3]))))
        diff = float((T - Tp).abs().max())
        check(ok and okp, f"frame {1 + i} not tracked (kernel path {ok}, plain path {okp})")
        bound = 2.0 * REFERENCE_CENTRE_ERR[i]
        check(err < bound, f"frame {1 + i} camera centre error {err} above {bound}")
        check(diff < POSE_TOL, f"frame {1 + i} kernel and plain Tcw differ by {diff}")
        errs.append(err)
    print(f"fused step: {len(REFERENCE_CENTRE_ERR)} frames tracked; camera-centre error per frame "
          f"{', '.join(f'{e:.5f}' for e in errs)} (bound: twice the JAX error), launches {launches} "
          f"for {len(calls)} extractions")

    with torch.no_grad():
        times = {}
        for name, s in (("kernel", step), ("plain", plain), ("kernel2", step), ("plain2", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_chain(s, args, images, device)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3 / len(REFERENCE_CENTRE_ERR)
    ms = min(times["kernel"], times["kernel2"])
    plain_ms = min(times["plain"], times["plain2"])
    print(f"fused step ms/frame: kernel path {ms:.2f} ({times['kernel']:.2f}, {times['kernel2']:.2f}), "
          f"plain path {plain_ms:.2f} ({times['plain']:.2f}, {times['plain2']:.2f})")
    return launches


def phase_system(device) -> dict:
    """The port's SlamSystem from frame 0 of the 60-frame synthetic sequence
    on the kernel path, loop closing on: initialisation, fused and unfused
    tracking, one local-mapping epoch and loop-closure attempt per keyframe.
    Gates: final state OK, tracked frames, ATE and loop closures against the
    JAX package's run, each kernel launched once per extraction, at least
    one frame through the fused step."""
    import torch

    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.run_slam import run_sequence, synthetic_config
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    seq = SyntheticSequence(n_frames=SYSTEM_FRAMES)
    cfg = synthetic_config()
    check(cfg.enable_loop_closing, "the synthetic configuration has loop closing off")
    system = SlamSystem(cfg, device=device)
    calls = extraction_counter(system.tracker.extractor, system.tracker.ini_extractor)
    with torch.no_grad():
        reset_launches()
        out = run_sequence(system, seq, SYSTEM_FRAMES)
        launches = read_launches()
    desc = system.map.kf_desc_pm1
    desc_mb = desc.numel() * desc.element_size() / 1e6
    st = out["epoch_stage_ms"]
    print(f"system: {SYSTEM_FRAMES} frames, tracked {out['tracked']}, state {out['state']}, "
          f"{out['n_kf']} keyframes, {out['n_lm']} landmarks, ATE {out['ate_rmse']:.6f}, "
          f"{out['fps']:.2f} frames/s inside track_monocular")
    for what in ("frame", "keyframe"):
        print(f"system {what} ms/frame by path (frames): " + ", ".join(
            f"{k} {v:.1f} ({out[what + '_count'][k]})" for k, v in out[what + "_ms"].items() if v is not None))
    print(f"system: {out['fused_frames']} frames through the fused step")
    print(f"system keyframe epochs: {out['epochs']}, ms/epoch: "
          + ", ".join(f"{k} {v:.1f}" for k, v in st.items()) + f", total {sum(st.values()):.1f}")
    closer = system.tracker.loop_closer
    print(f"system loop closing: {closer.n_attempts} attempts, {out['loop_closures']} closures, ms per keyframe "
          "epoch: " + ", ".join(f"{k} {st.get(k, 0.0):.2f}" for k in ("lc_detect", "lc_sim3", "lc_correct",
                                                                     "lc_global_ba")))
    print(f"system kf_desc_pm1 on the device: {tuple(desc.shape)} {desc.dtype}, {desc_mb:.1f} MB; launches {launches} "
          f"for {len(calls)} extractions")
    check(out["state"] == "OK", f"system ended in state {out['state']}")
    need = REFERENCE_SYSTEM_TRACKED - 2
    check(out["tracked"] >= need, f"system tracked {out['tracked']} frames, fewer than {need}")
    bound = max(2.0 * REFERENCE_SYSTEM_ATE, 0.05)
    check(out["ate_rmse"] < bound, f"system ATE {out['ate_rmse']} not under {bound}")
    check(out["loop_closures"] == REFERENCE_SYSTEM_CLOSURES,
          f"system closed {out['loop_closures']} loops, the JAX package {REFERENCE_SYSTEM_CLOSURES}")
    check(closer.n_attempts > 0, "no loop-closure attempt")
    check_launches(launches, calls, "the system", SYSTEM_FRAMES)
    check(out["fused_frames"] > 0, "no frame went through the fused step")
    return launches, out, system


def phase_relocalize(device) -> dict:
    """tests/test_e2e.py's kidnapped camera at the synthetic configuration
    on the kernel path: track 28 frames of the strafe (700 points, seed 3),
    feed 3 blank frames (LOST), feed frame 20 again (relocalised: state OK,
    pose within RELOC_T_TOL / RELOC_R_TOL of the port's own frame-20
    estimate), then frame 21 (tracked). Each kernel launches once per
    extraction, the blank frames included."""
    import numpy as np
    import torch

    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.run_slam import synthetic_config
    from orbslam_in_practice_tpu_torch.slam.tracking import TrackingState
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    seq = SyntheticSequence(n_frames=RELOC_TRACK_FRAMES, n_points=700, kind="strafe", seed=3)
    system = SlamSystem(synthetic_config(), device=device)
    calls = extraction_counter(system.tracker.extractor, system.tracker.ini_extractor)
    blank = np.zeros((seq.height, seq.width), np.float32)
    poses = {}
    with torch.no_grad():
        reset_launches()
        for i in range(RELOC_TRACK_FRAMES):
            pose = system.track_monocular(seq.render(i), 0.1 * i)
            if pose is not None:
                poses[i] = pose
        state_tracked, n_kf = system.state, system.map.n_kf_active()
        for k in range(3):
            system.track_monocular(blank, 3.0 + 0.1 * k)
        state_lost = system.state
        image = seq.render(RELOC_FRAME)
        sync(device)
        t0 = time.perf_counter()
        pose = system.track_monocular(image, 4.0)
        sync(device)
        reloc_ms = (time.perf_counter() - t0) * 1e3
        path, state_reloc = system.tracker.frame_path, system.state
        after = system.track_monocular(seq.render(RELOC_FRAME + 1), 4.1)
        launches = read_launches()
    print(f"relocalize: {len(poses)} of {RELOC_TRACK_FRAMES} frames tracked, {n_kf} keyframes, state {state_tracked.name}"
          f" -> {state_lost.name} after 3 blank frames -> {state_reloc.name} on frame {RELOC_FRAME} ({path}, "
          f"{reloc_ms:.1f} ms) -> {system.state.name} on frame {RELOC_FRAME + 1}; launches {launches} for "
          f"{len(calls)} extractions")
    check(state_tracked == TrackingState.OK and RELOC_FRAME in poses and n_kf > 5,
          f"relocalize: tracking ended {state_tracked.name} with {n_kf} keyframes")
    check(state_lost == TrackingState.LOST, f"relocalize: {state_lost.name} after the blank frames, not LOST")
    check(state_reloc == TrackingState.OK and path == "reloc" and pose is not None, "relocalize: not relocalised")
    dt = float(np.abs(pose[:3, 3] - poses[RELOC_FRAME][:3, 3]).max())
    dr = float(np.abs(pose[:3, :3] - poses[RELOC_FRAME][:3, :3]).max())
    print(f"relocalize: pose against the earlier estimate: translation {dt:.4f} (tolerance {RELOC_T_TOL}), "
          f"rotation {dr:.4f} (tolerance {RELOC_R_TOL})")
    check(dt < RELOC_T_TOL and dr < RELOC_R_TOL, f"relocalize: pose off by {dt} / {dr}")
    check(after is not None and system.state == TrackingState.OK, "relocalize: the next frame was not tracked")
    check_launches(launches, calls, "relocalize", RELOC_TRACK_FRAMES + 5)
    return launches


def phase_loop(device) -> dict:
    """tests/test_e2e_long_sequence.py's live loop closure on the kernel
    path: a noisy orbit (340 frames, 700 points, seed 5, 2 pi / 280 a frame,
    depth 3-9, spread (6, 5), pixel noise 1.0, brightness jitter 0.1) at 600
    features, 4 levels, fps 10, 48 keyframe and 4096 landmark slots. Gates:
    state OK, > 90% tracked, more insertions than keyframe slots, >= 1
    closure, ATE < 0.6 of the ATE just before the first closure and < 1% of
    the path; each kernel launched once per extraction."""
    import numpy as np
    import torch

    from orbslam_in_practice_tpu_torch.config import SlamConfig
    from orbslam_in_practice_tpu_torch.io.evaluation import ate_rmse
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.slam.tracking import TrackingState
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    seq = SyntheticSequence(
        n_frames=LOOP_FRAMES, n_points=700, kind="orbit", seed=5, orbit_step=2 * math.pi / 280,
        depth_range=(3.0, 9.0), spread=(6.0, 5.0), noise_sigma=1.0, brightness_jitter=0.1,
    )
    cfg = SlamConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480, n_features=600, n_levels=4,
                     fps=10.0, k_max=LOOP_K_MAX, l_max=LOOP_L_MAX)
    system = SlamSystem(cfg, device=device)
    tracker = system.tracker
    closer = tracker.loop_closer
    calls = extraction_counter(tracker.extractor, tracker.ini_extractor)
    gt = seq.gt_centers()
    n_tracked, ate_pre, pre_snapshot, track_s = 0, None, None, 0.0
    with torch.no_grad():
        reset_launches()
        for i in range(LOOP_FRAMES):
            if closer.n_closures == 0:
                pre_snapshot = list(system.get_trajectory())
            image = seq.render(i)
            sync(device)
            t0 = time.perf_counter()
            n_tracked += system.track_monocular(image, 0.1 * i) is not None
            sync(device)
            track_s += time.perf_counter() - t0
            if closer.n_closures >= 1 and ate_pre is None and pre_snapshot:
                ate_pre = ate_rmse(pre_snapshot, gt)[0]  # the drift just before the first closure
        launches = read_launches()
    rmse, n_aligned, _ = ate_rmse(system.get_trajectory(), gt)
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    insertions = int(np.asarray(tracker.map.kf_seq).max()) + 1
    print(f"loop: {LOOP_FRAMES} frames, tracked {n_tracked}, state {system.state.name}, {insertions} keyframe "
          f"insertions into {LOOP_K_MAX} slots ({tracker.map.n_kf_active()} active), "
          f"{tracker.map.n_lm_active()} landmarks, {LOOP_FRAMES / track_s:.2f} frames/s inside track_monocular")
    print(f"loop: {closer.n_closures} closures in {closer.n_attempts} attempts; ATE before the first closure "
          f"{ate_pre}, after the run {rmse:.4f} over a {path_len:.2f} path ({100 * rmse / path_len:.2f}%)")
    for c in closer.closures:
        print(f"loop closure at frame {c['frame']} (keyframe slot {c['kf']}, seq {c['kf_seq']}) to candidate slot "
              f"{c['cand']} (seq {c['cand_seq']}), scale {c['scale']:.4f}, {c['inliers']} inliers, ms: "
              + ", ".join(f"{k} {v:.1f}" for k, v in c["ms"].items()))
    print(f"loop: launches {launches} for {len(calls)} extractions")
    check(system.state == TrackingState.OK, f"loop: ended in state {system.state.name}")
    check(n_tracked > 0.9 * LOOP_FRAMES, f"loop: tracked {n_tracked} of {LOOP_FRAMES}")
    check(insertions > LOOP_K_MAX, f"loop: {insertions} insertions, not more than {LOOP_K_MAX} slots")
    check(tracker.map.n_kf_active() <= LOOP_K_MAX and tracker.map.n_lm_active() < LOOP_L_MAX, "loop: map overflow")
    check(closer.n_closures >= 1, "loop: no loop closure")
    check(n_aligned > 0.9 * LOOP_FRAMES, f"loop: {n_aligned} frames aligned")
    check(ate_pre is not None and rmse < 0.6 * ate_pre, f"loop: ATE {rmse} not under 0.6 of {ate_pre}")
    check(rmse < 0.01 * path_len, f"loop: ATE {rmse} not under 1% of the {path_len} path")
    check_launches(launches, calls, "loop", LOOP_FRAMES)
    return launches


def _print_paths(label: str, out: dict) -> None:
    for what in ("frame", "keyframe"):
        print(f"{label} {what} ms/frame by path (frames): " + ", ".join(
            f"{k} {v:.1f} ({out[what + '_count'][k]})" for k, v in out[what + "_ms"].items() if v is not None))


def phase_async(device, sync_out: dict) -> dict:
    """``phase_system``'s 60 frames and configuration with
    ``async_mapping=True``: the keyframe epochs and loop closing in the
    worker thread. Gates: state OK, >= ASYNC_MIN_TRACKED tracked, ATE under
    max(2 x REFERENCE_ASYNC_ATE, 0.05), no closure, never more than
    QUEUE_MAX epochs pending, the drain within 120 s with no worker error,
    shutdown joining the worker, each kernel launched once per extraction
    (the worker extracts nothing)."""
    import dataclasses

    import torch

    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.run_slam import run_sequence, synthetic_config
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    seq = SyntheticSequence(n_frames=SYSTEM_FRAMES)
    system = SlamSystem(dataclasses.replace(synthetic_config(), async_mapping=True), device=device)
    driver = system.tracker.async_driver
    check(driver is not None and driver.is_alive(), "async_mapping started no worker")
    calls = extraction_counter(system.tracker.extractor, system.tracker.ini_extractor)
    with torch.no_grad():
        reset_launches()
        out = run_sequence(system, seq, SYSTEM_FRAMES, drain_timeout=120.0)
        launches = read_launches()
    print(f"async: {SYSTEM_FRAMES} frames, tracked {out['tracked']}, state {out['state']}, {out['n_kf']} keyframes, "
          f"{out['n_lm']} landmarks, ATE {out['ate_rmse']:.6f}, {out['loop_closures']} closures; "
          f"{out['fps']:.2f} frames/s inside track_monocular against the synchronous run's {sync_out['fps']:.2f} "
          f"(tracked {sync_out['tracked']}, ATE {sync_out['ate_rmse']:.6f})")
    _print_paths("async", out)
    st = out["epoch_stage_ms"]
    print(f"async keyframe epochs: {out['epochs']} ({out['epochs_done_while_tracking']} finished while tracking went "
          f"on, at most {out['max_pending']} pending, drain after the last frame {out['drain_ms']:.1f} ms), "
          "ms/epoch on the worker: " + ", ".join(f"{k} {v:.1f}" for k, v in st.items()))
    print(f"async: launches {launches} for {len(calls)} extractions")
    check(out["state"] == "OK", f"async ended in state {out['state']}")
    check(out["tracked"] >= ASYNC_MIN_TRACKED, f"async tracked {out['tracked']}, fewer than {ASYNC_MIN_TRACKED}")
    bound = max(2.0 * REFERENCE_ASYNC_ATE, 0.05)
    check(out["ate_rmse"] < bound, f"async ATE {out['ate_rmse']} not under {bound}")
    check(out["loop_closures"] == 0, f"async closed {out['loop_closures']} loops")
    check(1 <= out["max_pending"] <= driver.QUEUE_MAX, f"async queue held {out['max_pending']} epochs")
    check(system.wait_idle(120.0) and driver.idle(), "async worker not idle after the drain")
    system.shutdown(60.0)
    check(not driver.is_alive(), "async worker not joined by shutdown")
    check_launches(launches, calls, "async", SYSTEM_FRAMES)
    return launches


def phase_dist_ba(device, system) -> None:
    """Distributed BA over DIST_SHARDS landmark shards: tests/test_dist_ba.py's
    problem on CPU tensors without a process group, then on the card in a
    one-rank NCCL group (a TCPStore on 127.0.0.1): each within the test's
    gates of the truth, the card within DIST_CARD_TOL of the CPU. Then
    ``distributed_global_ba`` on ``system``'s final map on the card: its
    robust cost must not rise. The group is destroyed at the end."""
    import os
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from orbslam_in_practice_tpu_torch.parallel.dist_ba import distributed_global_ba, map_problem, problem_cost
    from orbslam_in_practice_tpu_torch.parallel.dist_ba_worker import make_problem, run
    from orbslam_in_practice_tpu_torch.parallel.mesh import make_mesh

    problem = dict(seed=0, n_cams=6, n_pts=256)
    truth = make_problem(**problem)
    cpu = run(DIST_SHARDS, "cpu", DIST_ITERATIONS, **problem)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    torch.cuda.set_device(device)
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0)
    try:
        mesh = make_mesh(DIST_SHARDS, device)
        check(mesh.distributed and mesh.local_shards == DIST_SHARDS, f"mesh {mesh}")
        ms = []
        for _ in range(2):  # the first call also sets up the NCCL communicator
            sync(device)
            t0 = time.perf_counter()
            card = run(DIST_SHARDS, device, DIST_ITERATIONS, **problem)
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        n_pts = len(truth["points"])
        errs = {
            "card-cpu poses": float(np.abs(card[0] - cpu[0]).max()),
            "card-cpu points": float(np.abs(card[1] - cpu[1]).max()),
            "card-truth poses": float(np.abs(card[0] - truth["poses"]).max()),
            "card-truth points": float(np.abs(card[1][:n_pts] - truth["points"]).max()),
            "cpu-truth poses": float(np.abs(cpu[0] - truth["poses"]).max()),
            "cpu-truth points": float(np.abs(cpu[1][:n_pts] - truth["points"]).max()),
        }
        print(f"dist BA: {problem['n_cams']} cameras, {n_pts} landmarks, {DIST_SHARDS} shards in a one-rank NCCL "
              f"group, {DIST_ITERATIONS} LM iterations in {ms[1]:.1f} ms (first call, with the communicator's set-up: "
              f"{ms[0]:.1f}; partition and transfers included); "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        for what in ("card", "cpu"):
            check(errs[f"{what}-truth poses"] < DIST_POSE_TRUTH_TOL and errs[f"{what}-truth points"] < DIST_POINT_TRUTH_TOL,
                  f"dist BA on the {what} not within the test's gates of the truth: {errs}")
        check(errs["card-cpu poses"] < DIST_CARD_TOL and errs["card-cpu points"] < DIST_CARD_TOL,
              f"dist BA on the card differs from the CPU: {errs}")

        smap = system.map
        K, inv_s2 = system.cfg.cam.K(), system.tracker.inv_level_sigma2.cpu().numpy()
        cost0 = problem_cost(map_problem(smap, K, inv_s2, DIST_SHARDS)[0], mesh)
        with torch.no_grad():
            sync(device)
            t0 = time.perf_counter()
            n_cams, n_points, n_obs = distributed_global_ba(smap, K, inv_s2, mesh, iterations=10)
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        cost1 = problem_cost(map_problem(smap, K, inv_s2, DIST_SHARDS)[0], mesh)
        print(f"dist global BA on the system's map: {n_cams} keyframes, {n_points} landmarks, {n_obs} observations, "
              f"{DIST_SHARDS} shards, 10 LM iterations in {ms:.1f} ms; robust cost {cost0:.2f} -> {cost1:.2f}")
        check(n_cams >= 3 and n_points > 100 and n_obs > n_points, "dist global BA: too small a map")
        check(math.isfinite(cost1) and cost1 <= cost0, f"dist global BA raised the cost {cost0} -> {cost1}")
    finally:
        dist.destroy_process_group()


def phase_dataset(device) -> dict:
    """tests/test_e2e_real_data_glue.py's TUM layout on the card: the strafe's
    first DATASET_FRAMES frames as 8-bit PGM under a temporary directory,
    ground truth 13 ms off the frames; ``load_tum`` decodes them with the
    native loader (built here), whose prefetch queue must give the same
    frames as ``read_image``; ``SlamSystem`` tracks them. Gates: tracked,
    aligned and ATE as the test's; each kernel launched once per
    extraction."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from orbslam_in_practice_tpu_torch.config import load_config
    from orbslam_in_practice_tpu_torch.io import datasets, native_loader
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.run_slam import run_frames
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    t0 = time.perf_counter()
    lib = native_loader.build()
    print(f"native loader built in {time.perf_counter() - t0:.1f} s: {lib.relative_to(ROOT)}")
    check(lib.parent == ROOT / "orbslam_in_practice_tpu_torch" / "build", f"native loader built into {lib}")
    seq = SyntheticSequence(n_frames=DATASET_FRAMES)
    gt = seq.gt_centers()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "rgb").mkdir()
        rgb, truth = ["# timestamp filename"], ["# timestamp tx ty tz qx qy qz qw"]
        for i in range(DATASET_FRAMES):
            img = np.clip(seq.render(i), 0, 255).astype(np.uint8)
            (d / "rgb" / f"{i:06d}.pgm").write_bytes(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode() + img.tobytes())
            rgb.append(f"{1305031102.0 + 0.1 * i:.6f} rgb/{i:06d}.pgm")
            truth.append(f"{1305031102.0 + 0.1 * i + 0.013:.6f} {gt[i][0]:.6f} {gt[i][1]:.6f} {gt[i][2]:.6f} 0 0 0 1")
        (d / "rgb.txt").write_text("\n".join(rgb) + "\n")
        (d / "groundtruth.txt").write_text("\n".join(truth) + "\n")
        (d / "cam.yaml").write_text("%YAML:1.0\nCamera.fx: 500.0\nCamera.fy: 500.0\nCamera.cx: 320.0\n"
                                    "Camera.cy: 240.0\nORBextractor.nFeatures: 800\nORBextractor.nLevels: 4\n")
        ds = datasets.load_tum(str(d))
        gt_ids, gt_pos = ds.gt_positions_for_frames()
        check(len(ds) == DATASET_FRAMES and len(gt_ids) == DATASET_FRAMES, "TUM layout: frames or association lost")
        queue = native_loader.PrefetchQueue(ds.image_paths, prefetch=4, n_threads=2)
        order = []
        for idx, img in queue:
            order.append(idx)
            check(np.array_equal(img, native_loader.read_image(ds.image_paths[idx])), f"prefetched frame {idx} differs")
        queue.close()
        check(order == list(range(DATASET_FRAMES)), f"prefetch order {order}")
        system = SlamSystem(load_config(str(d / "cam.yaml")), device=device)
        calls = extraction_counter(system.tracker.extractor, system.tracker.ini_extractor)
        with torch.no_grad():
            reset_launches()
            out = run_frames(system, ds.frames(), gt_pos, gt_ids)
            launches = read_launches()
    print(f"dataset: TUM layout, {DATASET_FRAMES} PGM frames through load_tum and the native loader (prefetch queue "
          f"equal to read_image), tracked {out['tracked']}, aligned {out['aligned_frames']}, ATE {out['ate_rmse']:.5f}, "
          f"state {out['state']}, {out['fps']:.2f} frames/s inside track_monocular; launches {launches} for "
          f"{len(calls)} extractions")
    check(out["tracked"] >= DATASET_MIN_TRACKED, f"dataset tracked {out['tracked']}")
    check(out["aligned_frames"] >= DATASET_MIN_ALIGNED, f"dataset aligned {out['aligned_frames']}")
    check(out["ate_rmse"] < DATASET_ATE, f"dataset ATE {out['ate_rmse']}")
    check_launches(launches, calls, "dataset", DATASET_FRAMES)
    return launches


_RENDER_SEQ = None  # a render worker's sequence


def _render_init(name: str) -> None:
    global _RENDER_SEQ
    from orbslam_in_practice_tpu_torch import regimes

    _RENDER_SEQ = regimes.build(name)[0]


def _render(i: int):
    return _RENDER_SEQ.render(i)


def rendered_ahead(name: str, n: int):
    """(timestamp, image) of frames 0..n-1 of the regime ``name``, in order,
    rendered by RENDER_WORKERS spawned processes ahead of the tracker (a
    1241x376 corridor frame takes ~0.6 s on one core). The processes are
    shut down when the generator ends or is closed."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from orbslam_in_practice_tpu_torch.run_slam import FRAME_DT

    pool = ProcessPoolExecutor(RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_render_init, initargs=(name,))
    try:
        for i, image in enumerate(pool.map(_render, range(n))):
            yield i * FRAME_DT, image
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def sim3_recorder(closer) -> list:
    """Wraps ``closer.compute_sim3``; returns the list it appends (keyframe
    frame, candidate frame, inliers) to for every candidate verified."""
    verified = []
    compute_sim3 = closer.compute_sim3

    def recorded(smap, kf_id, cand, *args):
        result = compute_sim3(smap, kf_id, cand, *args)
        verified.append((int(smap.kf_frame_id[kf_id]), int(smap.kf_frame_id[cand]), int(result[4])))
        return result

    closer.compute_sim3 = recorded
    return verified


def run_regime(device, name: str):
    """``SlamSystem`` on the regime ``name`` (``regimes.build``) on the
    kernel path, loop closing on, timed by ``run_frames``, its frames
    rendered ahead (``rendered_ahead``). Prints the
    port's tracked, aligned, ATE, keyframes, landmarks, closures and
    frames/s beside the JAX package's (REFERENCE_REGIMES), ms/frame by
    path and the phase's wall seconds; checks that each kernel launched
    once per extraction. Returns (run_frames' dict, the system, the
    launches, the per-frame log)."""
    import numpy as np
    import torch

    from orbslam_in_practice_tpu_torch import regimes
    from orbslam_in_practice_tpu_torch.run_slam import run_frames
    from orbslam_in_practice_tpu_torch.slam.loop_closing import MIN_INLIERS
    from orbslam_in_practice_tpu_torch.system import SlamSystem
    from orbslam_in_practice_tpu_torch.utils.logging import FrameLog

    t0 = time.perf_counter()
    seq, cfg, n = regimes.build(name)
    system = SlamSystem(cfg, device=device)
    calls = extraction_counter(system.tracker.extractor, system.tracker.ini_extractor)
    verified = sim3_recorder(system.tracker.loop_closer)
    log = FrameLog()
    gt = seq.gt_centers()[:n]
    frames = rendered_ahead(name, n)
    try:
        with torch.no_grad():
            reset_launches()
            out = run_frames(system, frames, gt, flog=log)
            launches = read_launches()
    finally:
        frames.close()
    wall = time.perf_counter() - t0
    out["path"] = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    ref = REFERENCE_REGIMES[name]
    closer = system.tracker.loop_closer
    print(f"{name}: {n} frames ({cfg.width}x{cfg.height}, {cfg.n_features} features, {cfg.k_max} keyframe and "
          f"{cfg.l_max} landmark slots), state {out['state']}; port | JAX package: tracked {out['tracked']} | "
          f"{ref['tracked']}, aligned {out['aligned_frames']} | {ref['aligned']}, ATE {out['ate_rmse']:.6f} | "
          f"{ref['ate']} ({100 * out['ate_rmse'] / out['path']:.3f}% of the {out['path']:.2f} path), keyframes {out['n_kf']} | {ref['n_kf']}, landmarks {out['n_lm']} | {ref['n_lm']}, "
          f"closures {out['loop_closures']} | {ref['closures']} ({closer.n_attempts} attempts); "
          f"{out['fps']:.2f} frames/s inside track_monocular, {out['fused_frames']} fused frames, "
          f"{out['epochs']} epochs, phase wall {wall:.1f} s")
    _print_paths(name, out)
    if verified:
        kf, cand, inliers = max(verified, key=lambda v: v[2])
        print(f"{name}: {len(verified)} loop candidates verified; the most inliers, {inliers} ({MIN_INLIERS} needed), "
              f"at keyframe frames {kf} -> {cand}, true centres {np.linalg.norm(gt[kf] - gt[cand]):.2f} apart")
    if ref["ate"] is not None and out["ate_rmse"] > 2.0 * ref["ate"]:
        print(f"{name}: the port's ATE {out['ate_rmse']:.6f} is more than twice the JAX package's {ref['ate']}")
    print(f"{name}: launches {launches} for {len(calls)} extractions")
    check_launches(launches, calls, name, n)
    return out, system, launches, log.records


def check_regime_gates(name: str, out: dict) -> None:
    """The JAX test's gates of REGIME_GATES[name], and state OK."""
    gates = REGIME_GATES[name]
    check(out["state"] == "OK", f"{name} ended in state {out['state']}")
    check(out["tracked"] > gates["tracked"], f"{name} tracked {out['tracked']}, not above {gates['tracked']}")
    if "aligned" in gates:
        check(out["aligned_frames"] > gates["aligned"],
              f"{name} aligned {out['aligned_frames']}, not above {gates['aligned']}")
    check(out["ate_rmse"] < gates["ate"], f"{name} ATE {out['ate_rmse']} not under {gates['ate']}")


def phase_regimes(device) -> list:
    """tests/test_e2e_motion_regimes.py: noisy strafe (40 frames), forward
    and rotation-dominant motion (50 each) at 1000 features, pixel noise 1.0
    and 10% exposure jitter, under the test's gates."""
    runs = []
    for name in ("strafe", "forward", "rotation"):
        out, _, launches, _ = run_regime(device, name)
        check_regime_gates(name, out)
        runs.append(launches)
    return runs


def phase_distortion(device) -> dict:
    """tests/test_e2e_distortion.py: the strafe through TUM1's lens, the
    extractor undistorting every frame. The test's gates, and the last
    tracked frame's undistorted coordinates more than 1 px from its raw
    ones somewhere."""
    out, system, launches, _ = run_regime(device, "distortion")
    check_regime_gates("distortion", out)
    check(out["n_kf"] >= DISTORTION_MIN_KF and out["n_lm"] > DISTORTION_MIN_LM,
          f"distortion: {out['n_kf']} keyframes, {out['n_lm']} landmarks")
    frame = system.tracker.last_frame
    check(frame is not None, "distortion: no last frame")
    valid = frame.valid
    shift = float((frame.xy - frame.xy_raw).abs()[valid].max())
    print(f"distortion: the last tracked frame's undistorted coordinates move up to {shift:.2f} px from the raw "
          f"ones ({int(valid.sum())} valid keypoints)")
    check(shift > DISTORTION_MIN_SHIFT, f"distortion: undistortion moved the keypoints only {shift} px")
    return launches


def phase_no_false_loop(device) -> dict:
    """tests/test_e2e_long_sequence.py::test_no_false_loop_closures_without_revisit:
    a noisy 60-frame strafe that revisits nothing, 48 keyframe slots. Gates:
    state OK, loop closing attempted and no closure."""
    out, system, launches, _ = run_regime(device, "no_false_loop")
    closer = system.tracker.loop_closer
    check(out["state"] == "OK", f"no_false_loop ended in state {out['state']}")
    check(closer.n_attempts >= 1, "no_false_loop: no loop-closure attempt")
    check(closer.n_closures == 0, f"no_false_loop: {closer.n_closures} false closures")
    return launches


def phase_kitti_res(device) -> dict:
    """tests/test_e2e_kitti_res.py: 25 frames at 1241x376, 1000 features,
    a 10-keyframe local window, under the test's gates."""
    out, _, launches, _ = run_regime(device, "kitti_res")
    check_regime_gates("kitti_res", out)
    return launches


def phase_kitti_turn(device) -> dict:
    """tests/test_e2e_kitti_scale.py::test_e2e_kitti_turn_regime: 160 frames
    of the 500-frame corridor world, through its first 90-degree turn
    (frames 90-126), at 2000 features and the production budgets. Gates:
    more than 90% of the frames tracked in state OK, no untracked run of
    TURN_MAX_LOST_RUN frames, ATE under 1.5% of the path, no local-BA
    truncation."""
    out, system, launches, log = run_regime(device, "kitti_turn")
    n = len(log)
    ok = [r["tracked"] and r["state"] == "OK" for r in log]
    lost_run = cur = 0
    for flag in ok:
        cur = 0 if flag else cur + 1
        lost_run = max(lost_run, cur)
    path = out["path"]
    pct = 100.0 * out["ate_rmse"] / path
    truncations = system.tracker.mapper.stats()["n_ba_truncations"]
    ref = REFERENCE_REGIMES["kitti_turn"]
    print(f"kitti_turn: port | JAX package: {sum(ok)} | {ref['tracked_ok']} of {n} frames tracked in state OK, "
          f"longest untracked run {lost_run} | {ref['lost_run']}, ATE {pct:.3f}% | {ref['ate_pct']}% of the "
          f"{path:.2f} path, {truncations} local-BA truncations, {out['local_map_truncations']} local-map clips, "
          f"{out['n_lm_evictions']} landmark evictions")
    check(sum(ok) > TURN_MIN_OK_FRACTION * n, f"kitti_turn: {sum(ok)} of {n} frames tracked in state OK")
    check(lost_run < TURN_MAX_LOST_RUN, f"kitti_turn: an untracked run of {lost_run} frames")
    check(pct < TURN_MAX_ATE_PCT, f"kitti_turn: ATE {out['ate_rmse']} is {pct}% of the {path} path")
    check(truncations == 0, f"kitti_turn: {truncations} local-BA truncations")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from orbslam_in_practice_tpu_torch.bench_kernels import (
        bench_levels, kitti_config, kitti_levels, tum1_config, tum1_levels,
    )
    from orbslam_in_practice_tpu_torch.bench_state import bench_config
    from orbslam_in_practice_tpu_torch.ops import cuda_build
    from orbslam_in_practice_tpu_torch.run_slam import synthetic_config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    a = phase_fast(device)
    # every extractor the main path runs, tracking (n) and initialisation
    # (2n): the bench's; the system's; TUM1's; distortion's and
    # no-false-loop's (600); the motion regimes' (1000) over the bench's
    # levels; KITTI resolution's (1000) and the turn's (2000) over KITTI's.
    # The JSON line reports the system's tracking extractor.
    bench, tum1, kitti = bench_levels(device), tum1_levels(device), kitti_levels(device)
    n_track, n_kitti = synthetic_config().n_features, kitti_config().n_features
    b = phase_patch(device, f"bench 4 levels, {n_track} features", bench, n_track)
    cases = [("bench 4 levels", bench, n) for n in (bench_config().n_features, 2 * n_track, 600, 1200, 1000, 2000)]
    cases += [("TUM1 8 levels", tum1, tum1_config().n_features)]
    cases += [("KITTI 4 levels", kitti, n) for n in (1000, n_kitti, 2 * n_kitti)]
    for label, levels, n in cases:
        b["max_abs_err"] = max(b["max_abs_err"], phase_patch(device, f"{label}, {n} features", levels, n)["max_abs_err"])
    phase_tum1(device)
    runs = [phase_step(device)]
    launches_system, out_system, system = phase_system(device)
    runs += [launches_system, phase_relocalize(device), phase_loop(device), phase_async(device, out_system),
             phase_dataset(device)]
    runs += phase_regimes(device)
    runs += [phase_distortion(device), phase_no_false_loop(device), phase_kitti_res(device), phase_kitti_turn(device)]
    phase_dist_ba(device, system)
    launches = {k: sum(run[k] for run in runs) for k in runs[0]}

    kernels = [
        {
            "name": "fast_score_nms",
            "route": "cuda",
            "source": "orbslam_in_practice_tpu_torch/csrc/fast_score_nms.cu",
            "replaces": "orbslam_in_practice_tpu/ops/pallas_fast.py:110",
            "launches": launches["fast_score_nms"],
            **a,
        },
        {
            "name": "orb_patch_features",
            "route": "cuda",
            "source": "orbslam_in_practice_tpu_torch/csrc/orb_patch.cu",
            "replaces": "orbslam_in_practice_tpu/ops/pallas_patch.py:172",
            "launches": launches["orb_patch_features"],
            **b,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
