"""Kernel timing helpers, and the extractor's kernel work on the card.

    python -m orbslam_in_practice_tpu_torch.bench_kernels [--reps 20] [--json PATH]

Profiles ``ORBExtractor`` on one rendered 640x480 frame at the main path's
four configurations: the bench step's 512 features over 4 levels, the
system's tracking (800) and initialisation (1600) extractors, and TUM1's
1000 features over 8 levels with distortion. For each it prints, per
extraction, the launches and device µs of each CUDA kernel and of all the
device work the extractor queues (the profiler's kernel records), and the
µs an extraction takes by CUDA events around back-to-back calls. It uses
only the extractor's public interface, so a copy of this file in another
checkout's package measures that checkout the same way; to compare two
versions, run both in one machine, in turns.

``chip_smoke.py`` times each kernel alone with the helpers here (device µs
a launch, wrapper µs a call, the plain version's µs) and holds it against
its bound (``bound``, ``fast_work``, ``patch_work``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms_plain
from orbslam_in_practice_tpu_torch.ops.image import build_pyramid
from orbslam_in_practice_tpu_torch.ops.orb import level_budgets, select_keypoints
from orbslam_in_practice_tpu_torch.regimes import build as build_regime
from orbslam_in_practice_tpu_torch.regimes import kitti_config
from orbslam_in_practice_tpu_torch.utils.profiling import BYTES_PER_S, OPS_PER_S

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("fast_score_nms_kernel", "orb_patch_kernel")  # csrc/*.cu
# kernel A's float instructions: the compass test (4 subtractions, 8
# comparisons) on each pixel of the 3 px interior; an arc of one polarity
# (16 FMAs for the margins, 48 min/max, 1 max with 0: arc_score) for each
# polarity that passes the test; NMS on every pixel (a thread's 4 outputs
# share 6 three-wide row maxima, 12 max; then 2 max and 1 compare each)
FAST_OPS_TEST, FAST_OPS_ARC, FAST_OPS_NMS = 12, 65, 6
# kernel B's float ops a keypoint: a separable 7-tap blur of the 39x39
# window ((39*45 + 39*39) * 13), the moments (709 disc pixels x 2), 512
# rotated samples (~8 each)
PATCH_OPS_PER_KP = (39 * 45 + 39 * 39) * 13 + 709 * 2 + 512 * 8
PATCH_WINDOW_BYTES = 45 * 45 * 4
PATCH_OUT_BYTES = 8 + 4 + 32 + 256  # yx in; angle, words, ±1 row out


def events_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back calls,
    by CUDA events: what the caller waits for, host enqueue included."""
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


def launch_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Median device milliseconds of the work ``fn`` queues: events around
    one call queued behind a ~0.5 ms busy-wait, so the card runs it back to
    back however slowly the host enqueues it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profile(fn, reps: int) -> list:
    """The device kernel records of ``reps`` calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [
        e for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]


def profiled_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device milliseconds of the launches of ``kernel`` (a substring
    of its name) that ``fn`` makes, by the profiler's kernel records."""
    us = [e.time_range.elapsed_us() for e in _profile(fn, reps) if kernel in e.name]
    return sum(us) / len(us) / 1e3 if us else float("nan")


def bound(ops: float, nbytes: float) -> tuple:
    """(bound ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = ops / OPS_PER_S, nbytes / BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def fast_arcs(img: torch.Tensor) -> tuple:
    """(brighter, darker): (H, W) bool masks of the pixels of the 3 px
    interior of ``img`` that pass kernel A's compass test for each
    polarity. A pixel outside them scores 0 that way."""
    c = img[3:-3, 3:-3]
    m = [img[6:, 3:-3] - c, img[3:-3, 6:] - c, img[:-6, 3:-3] - c, img[3:-3, :-6] - c]  # compass 0, 4, 8, 12
    bright = torch.zeros_like(img, dtype=torch.bool)
    dark = torch.zeros_like(img, dtype=torch.bool)
    for k in range(4):
        a, b = m[k], m[(k + 1) % 4]
        bright[3:-3, 3:-3] |= (a > 0) & (b > 0)
        dark[3:-3, 3:-3] |= (a < 0) & (b < 0)
    return bright, dark


def fast_work(levels: list) -> tuple:
    """(ops, bytes) kernel A needs for these levels: the compass test on the
    interior, an arc for each polarity that passes it, NMS on every pixel;
    each pixel read once and written once."""
    ops = nbytes = 0
    for img in levels:
        h, w = img.shape
        arcs = sum(int(m.sum()) for m in fast_arcs(img))
        ops += (h - 6) * (w - 6) * FAST_OPS_TEST + arcs * FAST_OPS_ARC + h * w * FAST_OPS_NMS
        nbytes += img.numel() * 8
    return ops, nbytes


def patch_work(levels: list, n: int) -> tuple:
    """(ops, bytes) kernel B needs for ``n`` keypoints over these levels."""
    pyramid_bytes = sum(img.numel() for img in levels) * 4
    return n * PATCH_OPS_PER_KP, min(pyramid_bytes, n * PATCH_WINDOW_BYTES) + n * PATCH_OUT_BYTES + 256 * 16


def bench_image(device) -> torch.Tensor:
    """Frame 1 of the benchmark scene (640x480)."""
    from orbslam_in_practice_tpu_torch.bench_state import bench_config
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence

    cfg = bench_config()
    seq = SyntheticSequence(
        n_frames=2, n_points=900, width=cfg.width, height=cfg.height,
        fx=cfg.fx, fy=cfg.fy, kind="strafe", seed=0,
    )
    return torch.from_numpy(seq.render(1)).to(device)


def bench_levels(device) -> list:
    """The 4 pyramid levels of ``bench_image``."""
    from orbslam_in_practice_tpu_torch.bench_state import bench_config

    cfg = bench_config()
    return build_pyramid(bench_image(device), cfg.n_levels, cfg.scale_factor)


def tum1_config():
    from orbslam_in_practice_tpu_torch.config import load_config

    return load_config(str(ROOT / "configs" / "TUM1.yaml"))


def tum1_image(device) -> torch.Tensor:
    """A rendered, distorted 640x480 frame with TUM1's camera."""
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence

    cfg = tum1_config()
    seq = SyntheticSequence(
        n_frames=2, n_points=900, width=cfg.width, height=cfg.height,
        fx=cfg.fx, fy=cfg.fy, seed=0, dist=cfg.cam.dist,
    )
    return torch.from_numpy(seq.render(1)).to(device)


def tum1_levels(device) -> list:
    cfg = tum1_config()
    return build_pyramid(tum1_image(device), cfg.n_levels, cfg.scale_factor)


def kitti_image(device) -> torch.Tensor:
    """Frame 1 of the KITTI turn regime's corridor world (1241x376)."""
    return torch.from_numpy(build_regime("kitti_turn")[0].render(1)).to(device)


def kitti_levels(device) -> list:
    """The 4 pyramid levels of ``kitti_image`` at ``kitti_config()`` (the
    turn regime's: 2000 features), 1,171,764 px."""
    cfg = kitti_config()
    return build_pyramid(kitti_image(device), cfg.n_levels, cfg.scale_factor)


def keypoints(levels: list, n_features: int) -> tuple:
    """``select_keypoints`` per level at the budgets of ``n_features``:
    (yx (N, 2) int32, level_start, valid (N,))."""
    budgets = level_budgets(n_features, len(levels), 1.2)
    picks = [select_keypoints(fast_score_nms_plain(img), b) for img, b in zip(levels, budgets)]
    start = [0]
    for p in picks:
        start.append(start[-1] + len(p[0]))
    return torch.cat([p[0] for p in picks]), start, torch.cat([p[2] for p in picks])


def extractor_cases(device) -> list:
    """(label, image, extractor) at the main path's four configurations."""
    from orbslam_in_practice_tpu_torch.bench_state import bench_config
    from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor
    from orbslam_in_practice_tpu_torch.run_slam import synthetic_config

    def make(cfg, n_features, cam=None):
        return ORBExtractor(
            n_features, cfg.scale_factor, cfg.n_levels, cfg.ini_th_fast, cfg.min_th_fast, cam=cam,
        ).to(device)

    bench, track, tum1 = bench_config(), synthetic_config(), tum1_config()
    image = bench_image(device)
    return [
        (f"bench, {bench.n_features} features, {bench.n_levels} levels", image, make(bench, bench.n_features)),
        (f"tracking, {track.n_features} features, {track.n_levels} levels", image, make(track, track.n_features)),
        (f"initialisation, {2 * track.n_features} features, {track.n_levels} levels", image,
         make(track, 2 * track.n_features)),
        (f"TUM1, {tum1.n_features} features, {tum1.n_levels} levels", tum1_image(device),
         make(tum1, tum1.n_features, tum1.cam)),
    ]


def extractor_profile(device, reps: int) -> list:
    """Per extraction at each of ``extractor_cases``: launches and device ms
    of each kernel of ``KERNELS`` and of all device work, by the profiler;
    ms by events around back-to-back extractions."""
    rows = []
    for label, image, extractor in extractor_cases(device):
        kernels = _profile(lambda: extractor(image), reps)
        row = {
            "case": label,
            "all_launches": len(kernels) / reps,
            "all_device_ms": sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3,
        }
        for name in KERNELS:
            us = [e.time_range.elapsed_us() for e in kernels if name in e.name]
            row[f"{name}_launches"] = len(us) / reps
            row[f"{name}_device_ms"] = sum(us) / reps / 1e3
        row["extraction_events_ms"] = events_ms(lambda: extractor(image), 50)
        print(f"{label}: " + ", ".join(
            f"{k} {v * 1e3:.2f} us" if k.endswith("ms") else f"{k} {v:g}" for k, v in row.items() if k != "case"
        ))
        rows.append(row)
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20, help="profiled extractions per configuration")
    parser.add_argument("--json", type=Path, help="write the results here as JSON")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; package {Path(__file__).parent}")
    with torch.no_grad():
        rows = extractor_profile(torch.device("cuda", 0), opts.reps)
    if opts.json:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        opts.json.write_text(json.dumps({"card": smi, "extractor": rows}, indent=1))


if __name__ == "__main__":
    main()
