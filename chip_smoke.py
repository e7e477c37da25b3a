#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``orbslam_in_practice_tpu_torch`` from
``csrc/``, checks each against its plain PyTorch version on the card at the
shapes the tracking step gives it, runs the TUM1 extractor (1000 features,
8 levels, radtan distortion), then drives the fused steady-state tracking
step over 10 rendered frames of the benchmark scene (640x480, 512 features,
4 levels, 16384 landmark slots) with the kernels and with the plain path,
feeding pose and velocity forward. Last it runs the whole system,
``SlamSystem``, from the first frame of the 60-frame synthetic sequence
(``python -m orbslam_in_practice_tpu_torch.run_slam --synthetic``'s
configuration: 800 features, 4 levels, 256 keyframe and 16384 landmark
slots): initialisation, tracking, local mapping, and the ATE against the
JAX package's figures. It prints times in microseconds per kernel call and
milliseconds per frame and per keyframe epoch, one JSON line describing the
kernels (launches summed over the tracking step's and the system's runs),
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
# the JAX package's SlamSystem on the same 60 frames and configuration, on
# the CPU (loop closing off): 58 of 60 frames tracked, ATE 0.015822 in scene
# units, 14 keyframes, 1322 landmarks. The port must track at least 2 frames
# fewer and stay under twice that ATE or tests/test_e2e.py's 0.05.
REFERENCE_SYSTEM_TRACKED = 58
REFERENCE_SYSTEM_ATE = 0.015822
SYSTEM_FRAMES = 60
ANGLE_TOL = 1e-3  # rad, kernel B vs its plain version
BIT_TOL = 0.005  # fraction of descriptor bits, kernel B vs its plain version
POSE_TOL = 1e-3  # Tcw entries, kernel path vs plain path


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_pyramid(device):
    """The 4 pyramid levels of frame 1 of the benchmark scene, on ``device``."""
    import torch

    from orbslam_in_practice_tpu_torch.bench_state import bench_config
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.ops.image import build_pyramid

    cfg = bench_config()
    seq = SyntheticSequence(
        n_frames=2, n_points=900, width=cfg.width, height=cfg.height,
        fx=cfg.fx, fy=cfg.fy, kind="strafe", seed=0,
    )
    img = torch.from_numpy(seq.render(1)).to(device)
    return build_pyramid(img, cfg.n_levels, cfg.scale_factor), cfg


def phase_fast(device) -> dict:
    """Kernel A against nms3x3(fast_score) on the card: bit-exact."""
    import torch

    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms, fast_score_nms_plain

    levels, _ = bench_pyramid(device)
    kitti = SyntheticSequence(n_frames=2, n_points=900, width=1241, height=376, seed=1)
    images = levels + [torch.from_numpy(kitti.render(1)).to(device)]
    ms = plain_ms = worst = 0.0
    for img in images:
        got, want = fast_score_nms(img), fast_score_nms_plain(img)
        check(torch.equal(got, want), f"kernel A differs from its plain version at {tuple(img.shape)}")
        worst = max(worst, float((got - want).abs().max()))
        check(int((want > 0).sum()) > 100, f"too few FAST maxima at {tuple(img.shape)}")
        k = cuda_ms(lambda: fast_score_nms(img), 200)
        p = cuda_ms(lambda: fast_score_nms_plain(img), 50)
        print(f"kernel A fast_score_nms {tuple(img.shape)}: {k * 1e3:.1f} us, plain {p * 1e3:.1f} us, bit-exact")
        if img is not images[-1]:
            ms, plain_ms = ms + k, plain_ms + p
    print(f"kernel A over the 4 bench levels: {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_patch(device, n_features: int | None = None) -> dict:
    """Kernel B against ic_angle + gaussian_blur7 + brief_descriptors on the
    card, at the real keypoints of each bench level: by default at the
    bench's budgets, else at those of ``n_features`` (the system's tracking
    extractor asks for 800, its initialisation extractor for 1600)."""
    import torch

    from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms_plain
    from orbslam_in_practice_tpu_torch.ops.cuda_patch import orb_patch_features, orb_patch_features_plain
    from orbslam_in_practice_tpu_torch.ops.hamming import unpack_bits
    from orbslam_in_practice_tpu_torch.ops.orb import level_budgets, orb_pattern, select_keypoints

    levels, cfg = bench_pyramid(device)
    budgets = level_budgets(n_features or cfg.n_features, cfg.n_levels, cfg.scale_factor)
    pattern = orb_pattern(device)
    worst = 0.0
    ms = plain_ms = 0.0
    for img, budget in zip(levels, budgets):
        yx, _, valid = select_keypoints(fast_score_nms_plain(img), budget)
        ang_k, desc_k = orb_patch_features(img, yx, pattern)
        ang_p, desc_p = orb_patch_features_plain(img, yx, pattern)
        check(bool(torch.isfinite(ang_k).all()), "kernel B angle not finite")
        v = valid
        d = torch.remainder(ang_k[v] - ang_p[v] + math.pi, 2 * math.pi) - math.pi
        err = float(d.abs().max())
        bits = float((unpack_bits(desc_k[v]) != unpack_bits(desc_p[v])).float().mean())
        check(err < ANGLE_TOL, f"kernel B angle error {err} at {tuple(img.shape)}")
        check(bits < BIT_TOL, f"kernel B bit mismatch {bits} at {tuple(img.shape)}")
        worst = max(worst, err)
        k = cuda_ms(lambda: orb_patch_features(img, yx, pattern), 200)
        p = cuda_ms(lambda: orb_patch_features_plain(img, yx, pattern), 50)
        ms, plain_ms = ms + k, plain_ms + p
        print(
            f"kernel B orb_patch_features {tuple(img.shape)} x {budget} keypoints ({int(v.sum())} valid): "
            f"{k * 1e3:.1f} us, plain {p * 1e3:.1f} us, angle err {err:.3g} rad (tolerance {ANGLE_TOL}), "
            f"bit mismatch {bits:.4%} (tolerance {BIT_TOL:.1%})"
        )
    print(f"kernel B over the 4 bench levels at {sum(budgets)} keypoints: {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_tum1(device) -> None:
    """The TUM1 extractor (1000 features, 8 levels, distortion) on a
    rendered, distorted frame: kernel path finite and equal to the plain
    path's keypoints at level 0."""
    import torch

    from orbslam_in_practice_tpu_torch.config import load_config
    from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence

    cfg = load_config(str(ROOT / "configs" / "TUM1.yaml"))
    seq = SyntheticSequence(
        n_frames=2, n_points=900, width=cfg.width, height=cfg.height,
        fx=cfg.fx, fy=cfg.fy, seed=0, dist=cfg.cam.dist,
    )
    img = torch.from_numpy(seq.render(1)).to(device)
    args = (cfg.n_features, cfg.scale_factor, cfg.n_levels, cfg.ini_th_fast, cfg.min_th_fast)
    fk = ORBExtractor(*args, cam=cfg.cam).to(device)(img)
    fp = ORBExtractor(*args, cam=cfg.cam, use_kernels=False).to(device)(img)
    for name in ("xy", "xy_raw", "angle", "response"):
        check(bool(torch.isfinite(getattr(fk, name)).all()), f"TUM1 {name} not finite")
    lvl0 = fk.octave == 0
    check(torch.equal(fk.valid, fp.valid), "TUM1 validity differs between kernel and plain paths")
    check(torch.equal(fk.xy_raw[lvl0], fp.xy_raw[lvl0]), "TUM1 level-0 keypoints differ")
    check(torch.equal(fk.xy[lvl0], fp.xy[lvl0]), "TUM1 level-0 undistorted keypoints differ")
    n_valid = int(fk.valid.sum())
    check(n_valid > 500, f"TUM1 extractor found only {n_valid} keypoints")
    print(f"TUM1 extractor: {fk.n_features} slots, {n_valid} valid, level-0 keypoints equal on both paths")


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
    from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms
    from orbslam_in_practice_tpu_torch.ops.cuda_patch import orb_patch_features
    from orbslam_in_practice_tpu_torch.slam.tracking import FusedSteadyStep

    cfg = bench_config()
    step, args, images, seq = build_bench_state(cfg, n_images=len(REFERENCE_CENTRE_ERR), device=device)
    plain = FusedSteadyStep(cfg, use_kernels=False).to(device)

    with torch.no_grad():
        fast_score_nms.launches = 0
        orb_patch_features.launches = 0
        tracked = run_chain(step, args, images, device)
        launches = {"fast_score_nms": fast_score_nms.launches, "orb_patch_features": orb_patch_features.launches}
        tracked_plain = run_chain(plain, args, images, device)
    for name, n in launches.items():
        check(n > 0, f"the tracking step never launched {name}")

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
          f"{', '.join(f'{e:.5f}' for e in errs)} (bound: twice the JAX error), launches {launches}")

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
    on the kernel path: initialisation, fused and unfused tracking, one
    local-mapping epoch per keyframe. Gates: final state OK, tracked frames
    and ATE against the JAX package's run, both kernels launched, at least
    one frame through the fused step."""
    import torch

    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms
    from orbslam_in_practice_tpu_torch.ops.cuda_patch import orb_patch_features
    from orbslam_in_practice_tpu_torch.run_slam import run_sequence, synthetic_config
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    seq = SyntheticSequence(n_frames=SYSTEM_FRAMES)
    system = SlamSystem(synthetic_config(), device=device)
    with torch.no_grad():
        fast_score_nms.launches = 0
        orb_patch_features.launches = 0
        out = run_sequence(system, seq, SYSTEM_FRAMES)
        launches = {"fast_score_nms": fast_score_nms.launches, "orb_patch_features": orb_patch_features.launches}
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
    print(f"system kf_desc_pm1 on the device: {tuple(desc.shape)} {desc.dtype}, {desc_mb:.1f} MB; launches {launches}")
    check(out["state"] == "OK", f"system ended in state {out['state']}")
    need = REFERENCE_SYSTEM_TRACKED - 2
    check(out["tracked"] >= need, f"system tracked {out['tracked']} frames, fewer than {need}")
    bound = max(2.0 * REFERENCE_SYSTEM_ATE, 0.05)
    check(out["ate_rmse"] < bound, f"system ATE {out['ate_rmse']} not under {bound}")
    for name, count in launches.items():
        check(count > 0, f"the system never launched {name}")
    check(out["fused_frames"] > 0, "no frame went through the fused step")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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
    b = phase_patch(device)
    # the system's tracking and initialisation extractors
    n_features = synthetic_config().n_features
    for n in (n_features, 2 * n_features):
        b["max_abs_err"] = max(b["max_abs_err"], phase_patch(device, n_features=n)["max_abs_err"])
    phase_tum1(device)
    step_launches = phase_step(device)
    system_launches = phase_system(device)
    launches = {k: step_launches[k] + system_launches[k] for k in step_launches}

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
