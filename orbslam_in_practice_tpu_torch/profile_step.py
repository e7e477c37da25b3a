"""Where the time goes on the card: the fused step, or the whole system.

    python -m orbslam_in_practice_tpu_torch.profile_step [--plain]
    python -m orbslam_in_practice_tpu_torch.profile_step --system [--frames 60]

Default: tracks the benchmark scene's frames (as ``chip_smoke.py`` does) and
prints ms/frame by the host clock around synchronised runs; then, under
``torch.profiler``, host and device ms/frame per stage span of the step, the
device's busy share of the profiled window, the device time per launch of
the package's own kernels (one launch of each per frame), and the operators
with the most host and device time.

``--system``: runs ``SlamSystem`` on the synthetic sequence of
``run_slam --synthetic`` once by the host clock (ms per frame kind and per
keyframe-epoch stage), then again under the profiler, and prints for every
span of the tracker's record (PERF.md's table) its count and
its host and device ms, with the device's busy share and the top operators.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from orbslam_in_practice_tpu_torch.bench_state import bench_config, build_bench_state

N_FRAMES = 10
SPANS = (
    "extract", "match_motion_r15", "match_motion_r30", "pose_opt_motion", "match_local", "pose_opt_local",
)
SYSTEM_SPANS = SPANS + (
    "track", "frame_prep", "local_map", "step_readback", "keyframe_decision", "keyframe_insert",
    "track_motion_model", "track_reference_kf", "track_local_map",
    "init_twoview", "init_global_ba", "kf_create", "kf_fuse", "kf_local_ba", "kf_cull", "kf_refresh",
    *(f"{stage}.{part}" for stage in ("kf_create", "kf_fuse") for part in ("dispatch", "wait", "apply")),
    "kf_local_ba.dispatch", "kf_local_ba.solve", "kf_local_ba.apply",
    "reloc", "lc_detect", "lc_sim3", "lc_correct", "lc_global_ba",
)
KERNELS = ("fast_score_nms_kernel", "orb_patch_kernel")  # csrc/*.cu


def _track(step, args, images):
    image, packed, velocity, pose, *tables = args
    for img in images:
        out = step(img, packed, velocity, pose, *tables)
        pose, velocity = out[1], out[3]
    return pose


def _device_kernels(prof, spans):
    return [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) and e.name not in spans
    ]


def _print_top_ops(events):
    for sort, label in (("self_cpu_time_total", "host"), ("self_device_time_total", "device")):
        print(f"top operators by self {label} time:")
        print(events.table(sort_by=sort, row_limit=15, max_name_column_width=60))


def profile_system(n_frames: int, device) -> None:
    """SlamSystem over the synthetic sequence: host clock, then profiled."""
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.run_slam import run_sequence, synthetic_config
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    seq = SyntheticSequence(n_frames=n_frames)
    with torch.no_grad():
        out = run_sequence(SlamSystem(synthetic_config(), device=device), seq, n_frames)
    print(f"host clock, no profiler: {out['fps']:.2f} frames/s, tracked {out['tracked']}/{n_frames}, "
          f"ATE {out['ate_rmse']:.6f}, {out['n_kf']} keyframes, {out['n_lm']} landmarks")
    for what in ("frame", "keyframe"):
        print(f"{what} ms/frame by path: " + ", ".join(
            f"{k} {v:.1f} ({out[what + '_count'][k]})" for k, v in out[what + "_ms"].items() if v is not None))
    print(f"{out['epochs']} keyframe epochs, ms/epoch: "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["epoch_stage_ms"].items()))

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_sequence(SlamSystem(synthetic_config(), device=device), seq, n_frames)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = _device_kernels(prof, SYSTEM_SPANS)
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profiled: {window_ms:.1f} ms host for {n_frames} frames, {len(kernels)} kernels, "
          f"{kernel_ms:.3f} ms of kernel time, device busy {kernel_ms / window_ms:.1%}")
    print("span                  calls   host ms total  kernel ms total  host ms/call")
    for e in events:
        if e.key in SYSTEM_SPANS and e.device_type == DeviceType.CPU:
            print(f"{e.key:<22}{e.count:>5}{e.cpu_time_total / 1e3:>16.2f}{e.device_time_total / 1e3:>17.3f}"
                  f"{e.cpu_time_total / 1e3 / max(e.count, 1):>14.2f}")
    _print_top_ops(events)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--plain", action="store_true", help="the plain path (use_kernels=False)")
    parser.add_argument("--system", action="store_true", help="profile SlamSystem on the synthetic sequence")
    parser.add_argument("--frames", type=int, default=60, help="frames of the --system run")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    device = torch.device("cuda", 0)
    if opts.system:
        print(f"card: {smi.stdout.strip()}; SlamSystem, {opts.frames} synthetic frames")
        profile_system(opts.frames, device)
        return
    step, args, images, _ = build_bench_state(
        bench_config(), n_images=N_FRAMES, device=device, use_kernels=not opts.plain
    )
    images = [torch.from_numpy(img).to(device) for img in images]
    n = len(images)
    print(f"card: {smi.stdout.strip()}; path: {'plain' if opts.plain else 'kernels'}; {n} frames")

    with torch.no_grad():
        _track(step, args, images)  # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _track(step, args, images)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / n)
        print("ms/frame (host clock, no profiler): " + ", ".join(f"{w:.2f}" for w in walls))

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _track(step, args, images)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = _device_kernels(prof, SPANS)
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profiled: {window_ms / n:.2f} ms/frame host, {len(kernels) / n:.0f} kernels and "
          f"{kernel_ms / n:.3f} ms of kernel time per frame, device busy {kernel_ms / window_ms:.1%}")
    for name in KERNELS:
        us = [e.time_range.elapsed_us() for e in kernels if name in e.name]
        if us:  # one launch per frame, over every pyramid level
            print(f"{name}: {len(us) / n:.0f} launches per frame; device us per launch: mean "
                  f"{sum(us) / len(us):.2f}, min {min(us):.2f}, max {max(us):.2f}")
    print("span                  host ms/frame  kernel ms/frame")
    for e in events:
        if e.key in SPANS and e.device_type == DeviceType.CPU:
            print(f"{e.key:<22}{e.cpu_time_total / 1e3 / n:>14.3f}{e.device_time_total / 1e3 / n:>17.3f}")
    _print_top_ops(events)


if __name__ == "__main__":
    main()
