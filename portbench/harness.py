"""One run of one cell: set-up, warm-up, the measured window of closed-loop
sessions, the traced frames, and the check.

The program under test is ``SlamSystem(cfg, device=...)`` with its public
``track_monocular(image, timestamp)``; the benchmark hands it rendered
frames and reads back poses, the tracker's per-frame path
(``Tracking.frame_path``, ``frame_keyframe``), the local mapper's and loop
closer's stage timers (``stage_s``), its ``record_function`` spans and its
kernels' names.

A session runs the cell's L frames from an empty map; when the window
outlasts it, the next session starts at once on a new ``SlamSystem`` (not
``reset()``: a reset keeps the frame counter, the trajectory and the last
keyframe's frame number, which a fresh system would not have). Its
construction counts in the window.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import check, metrics, trace
from portbench.reference.extract import build_pyramid, level_budgets
from portbench.scene import TorchRenderer
from portbench.traffic import build_sequence


def _stage_s(system) -> dict:
    tr = system.tracker
    out = dict(tr.mapper.stage_s)
    if tr.loop_closer is not None:
        out.update(tr.loop_closer.stage_s)
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(system, frames: list, fps: float, n_frames: int) -> None:
    """A throwaway session of the first ``n_frames`` frames: the mix sets it
    to pass initialisation and at least one keyframe epoch."""
    for i, img in enumerate(frames[:n_frames]):
        system.track_monocular(img, i / fps)
    sync(system.tracker.device)
    system.shutdown()


def _track(system, img, i: int, fps: float, session: int, device, traced: bool) -> tuple:
    """One frame through ``track_monocular``, timed from the call to its
    synchronised return; returns (the frame's record, its pose or None)."""
    from torch.profiler import record_function

    tracker = system.tracker
    before = _stage_s(system)
    ctx = record_function(f"{trace.FRAME_SPAN}:{session}:{i}") if traced else contextlib.nullcontext()
    ta = time.perf_counter()
    with ctx:
        pose = system.track_monocular(img, i / fps)
        sync(device)
    ms = (time.perf_counter() - ta) * 1e3
    after = _stage_s(system)
    return {
        "s": session, "i": i, "ms": ms, "path": tracker.frame_path, "kf": bool(tracker.frame_keyframe),
        "pose": pose is not None,
        "stage_ms": {k: (v - before.get(k, 0.0)) * 1e3 for k, v in after.items() if v != before.get(k, 0.0)},
        "prof": traced,
    }, pose


def run_window(make_system, frames: list, fps: float, seconds: float, device, rec: check.Recorder,
               trace_span: tuple = (0, 0)):
    """Closed-loop sessions until ``seconds`` have passed: every frame
    timed by the host clock from the call to its synchronised return. With
    ``trace_span`` (first frame, frames), once the window has closed a new
    session runs the same frames up to the end of that stretch and the
    stretch runs under the profiler: frames the window's sessions run, and
    no window frame slowed by the profiler or by what it leaves behind.

    ``failed`` counts the window's frames that got no pose after their
    session's map was initialised, and every frame of a session that ran
    all its frames without initialising; a session the window's end cut
    during initialisation counts none.

    Returns (frame records, the traced stretch's included, window seconds,
    failed frames, Trace or None, session-0 poses)."""
    from torch.profiler import ProfilerActivity, profile

    out, poses0 = [], {}
    failed = 0
    sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    session = 0
    while time.perf_counter() < deadline:
        system = make_system()
        if session == 0:
            rec.attach(system)
        initialized, n_session = False, 0
        for i, img in enumerate(frames):
            if time.perf_counter() >= deadline:
                break
            rec.frame = i if session == 0 else -1
            record, pose = _track(system, img, i, fps, session, device, False)
            out.append(record)
            n_session += 1
            if pose is not None:
                initialized = True
                if session == 0:
                    poses0[i] = pose
                    rec.first_pose = min(i, rec.first_pose if rec.first_pose is not None else i)
            elif initialized:
                failed += 1
        else:
            if not initialized:
                failed += n_session
        rec.detach()
        system.shutdown()
        del system
        session += 1
    window_s = time.perf_counter() - t0

    t_first, n_trace = trace_span
    tr = None
    if n_trace:
        system = make_system()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        for i, img in enumerate(frames[: t_first + n_trace]):
            if i == t_first:
                prof.start()
            record, _ = _track(system, img, i, fps, session, device, i >= t_first)
            if i >= t_first:
                out.append(record)
        prof.stop()
        system.shutdown()
        del system
        tr = trace.read_profile(prof)
    return out, window_s, failed, tr, poses0


def ate_pct(poses: dict, gt_poses: np.ndarray) -> float | None:
    """Sim(3)-aligned RMSE of the camera centres (Umeyama) over the frames
    that got a pose, in percent of the ground-truth path they span."""
    ids = sorted(poses)
    if len(ids) < 3:
        return None
    est = np.stack([-(poses[i][:3, :3].T @ poses[i][:3, 3]) for i in ids]).astype(np.float64)
    gt = np.stack([-(gt_poses[i][:3, :3].T @ gt_poses[i][:3, 3]) for i in ids]).astype(np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(ids))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (E**2).sum() / len(ids)
    s = np.trace(np.diag(D) @ S) / var_e if var_e > 0 else 1.0
    aligned = s * E @ R.T + mu_g
    rmse = float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=-1))))
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1)))
    return 100.0 * rmse / path if path > 0 else None


def _quarters(ms: list) -> list:
    """The median of each quarter of ``ms``, in order."""
    return [float(np.median(q)) for q in np.array_split(np.asarray(ms), 4) if len(q)] if len(ms) >= 4 else []


def end_to_end(records: list, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics: frames that returned in the window over the
    whole window's seconds, the 90th percentile of every frame's latency,
    and the set-up seconds."""
    ms = [f["ms"] for f in records]
    return {
        "frames_per_s": len(records) / window_s if window_s > 0 and records else None,
        "frame_ms_p90": float(np.percentile(ms, 90, method="linear")) if ms else None,
        "setup_s": setup_s,
    }


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float, control: bool = False):
    """One run of ``cell``; returns the result line's fields (without
    ``device`` kind and count) and the compared rows. ``control`` also
    computes the control's numbers (``result["control"]``): the tests and
    ``portbench/control.py`` ask for it, a benchmark run never does."""
    from orbslam_in_practice_tpu_torch.config import SlamConfig
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    settings = cell.config["settings"]
    fps = float(settings["fps"])
    seq = build_sequence(cell.mix, settings, seed)
    renderer = TorchRenderer(seq, device)
    frames = [renderer.render(i) for i in range(seq.n_frames)]
    del renderer
    cfg = SlamConfig(**settings)
    build_s = None
    if device.type == "cuda":
        # the kernels' library, built by nvcc on a checkout's first run and
        # found in the program's cache after: its seconds are part of
        # set-up, and shown apart
        from orbslam_in_practice_tpu_torch.ops import cuda_build

        t_build = time.perf_counter()
        cuda_build.library()
        build_s = time.perf_counter() - t_build
    with torch.no_grad():
        warm_up(SlamSystem(cfg, device=device), frames, fps, cell.mix["warmup"]["frames"])
        rec = check.Recorder(cell.mix["check"], seed)
        sync(device)
        setup_s = time.time() - t_start
        span = (cell.mix["trace"]["first_frame"], cell.mix["trace"]["frames"]) if traced else (0, 0)
        records, window_s, failed, tr, poses0 = run_window(
            lambda: SlamSystem(cfg, device=device), frames, fps, seconds, device, rec, span)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window = [f for f in records if not f["prof"]]
    attempted = len(window)
    ms = [f["ms"] for f in window]
    metric_values = {}
    if traced:
        budgets = level_budgets(settings["n_features"], settings["n_levels"], settings["scale_factor"])
        by_frame = {(f["s"], f["i"]): f for f in records}

        def levels(s, i):
            img = frames[i]
            if by_frame[(s, i)]["path"] in ("fused", "fused_fallback"):
                img = check.encode(img).astype(np.float32) * np.float32(1.0 / 256.0)
            pyr = build_pyramid(torch.from_numpy(np.asarray(img, np.float32)).to(device), settings["n_levels"],
                                settings["scale_factor"])
            return [lv for lv, b in zip(pyr, budgets) if b > 0]

        r = trace.Records(frames=records, trace=tr, settings=settings, levels=levels)
        for m in cell.per_layer:
            v = metrics.reader(m["name"])(r)
            if v is not None:
                metric_values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(window, window_s, setup_s)
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metric_values[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    t_check = time.perf_counter()
    with torch.no_grad():
        numbers = check.evaluate(rec, frames, settings, device)
    check_s = time.perf_counter() - t_check
    n0 = sum(1 for f in window if f["s"] == 0)
    numbers["untracked"] = 1.0 - len(poses0) / n0 if n0 else None
    correct, rows = check.judge(numbers, cell.checks)
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metric_values,
        "device": {"memory_peak_bytes": int(peak)},
        "info": {
            "window_s": window_s, "check_s": check_s, "build_s": build_s, "sessions": 1 + max((f["s"] for f in window), default=0),
            "frames_session0": sum(1 for f in window if f["s"] == 0),
            "tracked_session0": len(poses0), "ate_pct_session0": ate_pct(poses0, seq.poses),
            "first_pose_session0": min(poses0, default=None),
            "epochs": sum(1 for f in window if f["kf"]),
            "paths": {p: sum(1 for f in window if f["path"] == p) for p in {f["path"] for f in window}},
            "frame_ms_p50": float(np.median(ms)) if ms else None,
            "fused_ms_p50_by_quarter": _quarters([f["ms"] for f in window
                                                  if f["path"] == "fused" and not f["kf"] and not f["prof"]]),
            "pose_px_median": numbers.get("pose_px_median"), "ba_px": numbers.get("ba_px"),
            "ba_cost": numbers.get("ba_cost"), "tri_made": numbers.get("tri_made"),
            "fuse_changed": numbers.get("fuse_changed"),
            "samples": {"extractions": len(rec.extractions), "steps": len(rec.steps), "bas": len(rec.bas),
                        "creates": len(rec.creates), "fuses": len(rec.fuses)},
        },
    }
    if control:
        with torch.no_grad():
            result["control"] = check.evaluate(rec, frames, settings, device, control=True)
            result["control"]["untracked"] = numbers["untracked"]  # the tracker's, not a stage's
            result["faults"] = check.faults(rec, settings, device)
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_ns() / 1e9
        result["device"]["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = trace.breakdown(tr)
    return result, rows
