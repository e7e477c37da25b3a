"""Tracked frames/s of the fused steady-state tracking step.

    python -m orbslam_in_practice_tpu_torch.bench [--device cuda|cpu] [--calls 8] [--trials 5]

The counterpart of the repository's root ``bench.py``, which measures the
JAX package. It prints one JSON line: ``metric`` ("tracked_frames_per_s"),
``value`` (the best trial's rate), ``unit``, ``vs_baseline``,
``baseline_fps``, ``baseline_source``, and beside them ``median`` and
``trials_fps`` (every trial's rate: host clocks vary between machines and
calls), ``tracked`` (frames of the last call that ended in state OK, read
after the clock stopped), ``tracked_min`` (the fewest of any timed call),
and the card's ``gpu`` name and ``power_limit_w`` from ``nvidia-smi``.

The step is ``FusedSteadyStep`` on ``bench_state.py``'s scene (640x480, 512
features over 4 levels, 16384 landmark slots): ORB extraction, motion-model
projection match with its radius retry, pose-only BA, local-map projection
match, pose-only BA, velocity update. One call chains REPS frames, pose and
velocity fed forward on the device with no host read inside the chain,
every call starting from the same pose and velocity. The frames are 4
batches of the scene's frames 1..REPS with uniform [0, 1) gray-level noise
(``noised_batches``). Timing: one warm-up call, then per trial ``--calls``
calls, a synchronise and a host read of the last pose; a trial's rate is
calls x REPS over its seconds.

The baseline is the same measurement on the CPU with the plain path
(``use_kernels=False``), BASELINE_CALLS calls in BASELINE_TRIALS trials,
measured in the run; ``BENCH_SKIP_CPU_BASELINE=1`` skips it
(``baseline_source`` "skipped", ``vs_baseline`` null). ``--device cuda``
without a card exits non-zero: it never measures the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.bench_kernels import bench_device, card, sync
from orbslam_in_practice_tpu_torch.bench_state import bench_config, build_bench_state
from orbslam_in_practice_tpu_torch.slam.tracking import encode_image

REPS = 10  # frames chained in one call
N_BATCHES, NOISE_SEED = 4, 1
BASELINE_CALLS, BASELINE_TRIALS = 3, 4


def noised_batches(images: np.ndarray, device, seed: int = NOISE_SEED, n: int = N_BATCHES) -> list:
    """``n`` copies of the (REPS, H, W) 8.8 fixed-point frames, each with
    its own uniform [0, 1) gray-level noise from ``default_rng(seed)``, as
    (REPS, H, W) uint16 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    gray = images.astype(np.float32) * (1.0 / 256.0)
    return [
        torch.from_numpy(encode_image(gray + rng.uniform(0, 1, images.shape).astype(np.float32))).to(device)
        for _ in range(n)
    ]


def chained_call(step, args):
    """call(batch) -> (Tcw of the last frame, (REPS,) bool frames tracked):
    the step over the batch's frames from ``args``' pose and velocity, each
    frame's pose and velocity fed to the next on the device."""
    _, packed, velocity, pose, *tables = args

    def call(batch):
        T, V, oks = pose, velocity, []
        for image in batch:
            _, T, _, V, _, ok, _ = step(image, packed, V, T, *tables)
            oks.append(ok)
        return T, torch.stack(oks)

    return call


def measure(call, batches: list, n_calls: int, trials: int, device) -> dict:
    """Each trial's frames/s and every timed call's frames tracked."""
    with torch.no_grad():
        float(call(batches[0])[0].sum())  # warm-up
        fps, tracked = [], []
        for _ in range(trials):
            sync(device)
            t0 = time.perf_counter()
            outs = [call(batches[i % len(batches)]) for i in range(n_calls)]
            sync(device)
            float(outs[-1][0].sum())  # host read of the last pose
            fps.append(n_calls * REPS / (time.perf_counter() - t0))
            tracked += [int(ok.sum()) for _, ok in outs]
    return {"trials_fps": fps, "tracked": tracked}


def run(device, n_calls: int, trials: int, use_kernels: bool = True) -> dict:
    """``measure`` of the bench step on ``device``."""
    step, args, images, _ = build_bench_state(bench_config(), n_images=REPS, device=device, use_kernels=use_kernels)
    return measure(chained_call(step, args), noised_batches(images, device), n_calls, trials, device)


def result_line(res: dict, baseline: dict | None, smi: str | None) -> dict:
    """The JSON line of ``run``'s result and the baseline's (None: skipped)."""
    fps = max(res["trials_fps"])
    base = max(baseline["trials_fps"]) if baseline is not None else None
    name, _, limit = (smi or "").rpartition(", ")
    try:
        limit_w = float(limit.removesuffix(" W"))
    except ValueError:
        limit_w = None
    return {
        "metric": "tracked_frames_per_s",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / base if base else None,
        "baseline_fps": base,
        "baseline_source": "measured_in_run" if baseline is not None else "skipped",
        "median": statistics.median(res["trials_fps"]),
        "trials_fps": res["trials_fps"],
        "tracked": res["tracked"][-1],
        "tracked_min": min(res["tracked"]),
        "gpu": name or None,
        "power_limit_w": limit_w,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--calls", type=int, default=8, help="calls (of REPS frames) a trial")
    parser.add_argument("--trials", type=int, default=5)
    opts = parser.parse_args(argv)
    device = bench_device(opts.device)
    smi = card() if device.type == "cuda" else None
    res = run(device, opts.calls, opts.trials)
    baseline = None
    if os.environ.get("BENCH_SKIP_CPU_BASELINE", "") != "1":
        baseline = run(torch.device("cpu"), BASELINE_CALLS, BASELINE_TRIALS, use_kernels=False)
    print(json.dumps(result_line(res, baseline, smi)))


if __name__ == "__main__":
    main()
