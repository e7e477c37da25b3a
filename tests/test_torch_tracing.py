"""The port's record of spans and counters (``utils/logging.py::StageTimer``)
on a tiny synthetic run on the CPU (strafe, 700 points, seed 3, 320x240,
300 features over 4 levels), through ``run_slam.run_frames`` and its
``--log`` lines:

- every fused frame records the step's six spans, ``frame_prep``,
  ``local_map`` and ``step_readback``; a frame's direct spans sum to no
  more than its ``track`` span and fill most of it, and a stage's parts to
  no more than the stage; the local map stays within LOCAL_MAP_MAX;
- a frame's ``kf_seq`` is set exactly when it inserted a keyframe, and its
  synchronous epoch's record holds the same spans as the frame;
- ``LocalMapper.stage_s`` keeps its five keys and the counter attributes
  are the frames' counts summed; a reset's new mapper counts from zero on
  the tracker's record;
- under ``torch.profiler`` every span is a user annotation inside its
  frame's ``track``, and no ``kf_`` or ``lc_`` span starts before the
  keyframe is inserted;
- with ``async_mapping`` each epoch record links to the frame that
  inserted its keyframe by ``kf_seq`` alone, with its queue wait, and no
  frame holds a ``kf_`` span;
- the record keeps every thread's spans and counts apart and its totals
  exact under a stress of many threads.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orbslam_in_practice_tpu_torch import run_slam
from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch.slam.local_mapping import STAGES as EPOCH_STAGES
from orbslam_in_practice_tpu_torch.slam.loop_closing import STAGES as LC_STAGES
from orbslam_in_practice_tpu_torch.slam.tracking import LOCAL_MAP_MAX, Tracking
from orbslam_in_practice_tpu_torch.system import SlamSystem
from orbslam_in_practice_tpu_torch.utils.logging import FrameLog, StageTimer

torch.set_num_threads(2)

N_FRAMES = 14  # untraced: initialisation at frame 4, then fused frames and epochs
N_TRACED = 3  # frames after them under the profiler
TINY = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, n_features=300, n_levels=4, fps=10.0,
            k_max=64, l_max=8192)
STEP_SPANS = ("extract", "match_motion_r15", "match_motion_r30", "pose_opt_motion", "match_local", "pose_opt_local")
FUSED_SPANS = STEP_SPANS + ("frame_prep", "local_map", "step_readback")
# spans that lie inside another span of the same frame
NESTED = {"local_map"} | {f"{s}.{p}" for s in EPOCH_STAGES for p in ("dispatch", "wait", "solve", "apply")}


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=N_FRAMES + N_TRACED, n_points=700, kind="strafe", seed=3, width=320,
                             height=240, fx=250.0, fy=250.0)


def _run(seq, tmp_path, async_mapping: bool):
    """``run_frames`` with a log: (system, summary, the frames' log lines,
    every epoch record it took, those after the drain included)."""
    cfg = SlamConfig(**TINY, async_mapping=async_mapping)
    system = SlamSystem(cfg, device="cpu")
    record = system.tracker.record
    taken, take = [], record.take_epochs

    def take_and_keep():
        epochs = take()
        taken.extend(epochs)
        return epochs

    record.take_epochs = take_and_keep
    path = tmp_path / "log.jsonl"
    frames = ((i * 0.1, seq.render(i)) for i in range(N_FRAMES))
    with torch.no_grad():
        out = run_slam.run_frames(system, frames, flog=FrameLog(str(path)))
    del record.take_epochs
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == N_FRAMES
    return system, out, lines, taken


@pytest.fixture(scope="module")
def sync_run(seq, tmp_path_factory):
    """The synchronous run, its frame and epoch log lines, then N_TRACED
    frames under the profiler: (system, summary, frames, epochs, traced
    frames' records, user annotations (name, start ns, end ns))."""
    system, out, frames, epochs = _run(seq, tmp_path_factory.mktemp("sync"), False)
    traced = []
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(N_FRAMES, N_FRAMES + N_TRACED):
            system.track_monocular(seq.render(i), i * 0.1)
            traced.append(dict(system.tracker.frame_record, path=system.tracker.frame_path))
    notes = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events() if e.is_user_annotation())
    return system, out, frames, epochs, traced, notes


@pytest.fixture(scope="module")
def async_run(seq, tmp_path_factory):
    system, out, frames, epochs = _run(seq, tmp_path_factory.mktemp("async"), True)
    system.shutdown()
    return system, out, frames, epochs


def test_fused_frames_record_the_step_and_its_host_stages(sync_run):
    _, out, frames, _, _, _ = sync_run
    fused = [f for f in frames if f["path"] == "fused"]
    assert len(fused) >= 3 and out["fused_frames"] == len(fused)
    for f in fused:
        assert set(FUSED_SPANS) <= set(f["spans_ms"]), f["spans_ms"]
        assert f["counts"]["local_map_size"] <= LOCAL_MAP_MAX
        for name in ("mm_candidates", "matches_r15", "matches_r30", "matches_local", "inliers"):
            assert f["counts"][name] >= 0, name
        assert f["counts"]["inliers"] <= f["counts"]["matches_local"]


def test_spans_nest_inside_the_frame(sync_run):
    _, _, frames, _, _, _ = sync_run
    assert len({f["path"] for f in frames}) >= 2  # initialisation, and the fused or unfused flow
    for f in frames:
        spans = f["spans_ms"]
        track = spans["track"]
        direct = sum(v for k, v in spans.items() if k != "track" and k not in NESTED)
        assert direct <= track and track <= f["ms"], f
        # the frame's own clock runs around the span, and the spans fill it
        assert f["ms"] - track < 2.0 + 0.05 * f["ms"], f
        if f["path"] == "fused":
            assert direct > 0.9 * track, f
        for stage in EPOCH_STAGES:
            parts = [v for k, v in spans.items() if k.startswith(stage + ".")]
            assert sum(parts) <= spans.get(stage, 0.0), (stage, spans)


def test_frame_kf_seq_links_the_synchronous_epoch(sync_run):
    system, out, frames, epochs, _, _ = sync_run
    kf_frames = [f for f in frames if f["keyframe"]]
    assert kf_frames and all((f["kf_seq"] >= 0) == f["keyframe"] for f in frames)
    assert [e["kf_seq"] for e in epochs] == [f["kf_seq"] for f in kf_frames]
    assert len(epochs) == out["epochs"]  # the run's; the traced frames run more
    for f, e in zip(kf_frames, epochs):
        assert "queue_wait_ms" not in e and f["epochs"] == [e]
        for name, ms in e["spans_ms"].items():
            assert f["spans_ms"][name] == pytest.approx(ms), name
        assert set(e["spans_ms"]) >= set(EPOCH_STAGES)
        for name, n in e["counts"].items():
            assert f["counts"][name] == n, name
    assert not any(k.startswith(("kf_", "lc_")) for f in frames if not f["keyframe"] for k in f["spans_ms"])


def test_stage_timers_and_totals_read_the_record(sync_run):
    system, out, frames, epochs, traced, _ = sync_run
    tr = system.tracker
    assert set(tr.mapper.stage_s) == set(EPOCH_STAGES)
    assert set(tr.loop_closer.stage_s) <= set(LC_STAGES)
    everything = frames + traced
    for name in EPOCH_STAGES:
        assert tr.mapper.stage_s[name] * 1e3 == pytest.approx(sum(f["spans_ms"].get(name, 0.0) for f in everything))

    def total(name):
        return sum(f["counts"].get(name, 0) for f in everything)

    assert tr.mapper.n_fuse_merges == total("merges") > 0
    assert tr.mapper.n_ba_obs_drops == total("ba_obs_dropped")
    assert tr.mapper.n_lm_evictions == total("landmarks_evicted")
    assert tr.n_local_map_truncations == total("local_map_truncated")
    assert tr.n_fused_frames == sum(f["path"] in ("fused", "fused_fallback") for f in everything)
    assert sum(e["counts"]["points_created"] for e in epochs) > 0
    assert out["n_fuse_merges"] <= tr.mapper.n_fuse_merges


def test_reset_hands_the_record_to_a_mapper_that_counts_from_zero():
    tr = Tracking(SlamConfig(**TINY), "cpu")
    assert tr.mapper.record is tr.record and tr.loop_closer.record is tr.record and tr.step.record is tr.record
    with tr.record.stage("kf_fuse"):
        tr.record.count("merges", 3)
    assert tr.mapper.n_fuse_merges == 3 and set(tr.mapper.stage_s) == {"kf_fuse"}
    tr.reset()
    assert tr.mapper.record is tr.record and tr.loop_closer.record is tr.record
    assert tr.mapper.n_fuse_merges == 0 and tr.mapper.stage_s == {} and tr.loop_closer.stage_s == {}
    assert tr.record.counters["merges"] == 3


def test_spans_are_annotations_inside_track_under_the_profiler(sync_run):
    _, _, _, _, traced, notes = sync_run
    tracks = [(s, e) for name, s, e in notes if name == "track"]
    assert len(tracks) == N_TRACED
    assert any(f["path"] == "fused" for f in traced) and any(f["kf_seq"] >= 0 for f in traced)
    recorded = set().union(*(f["spans_ms"] for f in traced))
    assert recorded == {name for name, _, _ in notes}
    for (lo, hi), f in zip(tracks, traced):
        inside = [(name, s, e) for name, s, e in notes if lo <= s and e <= hi and name != "track"]
        assert {name for name, _, _ in inside} == set(f["spans_ms"]) - {"track"}
        mapping = [s for name, s, _ in inside if name.startswith(("kf_", "lc_"))]
        if mapping:
            inserted = max(e for name, _, e in inside if name == "keyframe_insert")
            step_end = max((e for name, _, e in inside if name in FUSED_SPANS + ("keyframe_decision",)), default=lo)
            assert step_end <= min(mapping) and inserted <= min(mapping)
    assert sum(e - s for _, s, e in notes if any(lo <= s and e <= hi for lo, hi in tracks)) > 0


def test_async_epochs_link_to_their_frames_by_kf_seq(async_run):
    system, out, frames, epochs = async_run
    inserted = {f["kf_seq"] for f in frames if f["keyframe"]}
    logged = [ep for f in frames for ep in f["epochs"]]
    assert logged == epochs[: len(logged)]  # the rest finished in the drain
    assert epochs and all((f["kf_seq"] >= 0) == f["keyframe"] for f in frames)
    assert {e["kf_seq"] for e in epochs} == inserted and len(epochs) == len(inserted)
    assert all(e["queue_wait_ms"] >= 0.0 and set(e["spans_ms"]) >= set(EPOCH_STAGES) for e in epochs)
    assert not any(k.startswith(("kf_", "lc_")) for f in frames for k in f["spans_ms"])
    assert out["queue_wait_ms"] == pytest.approx(np.mean([e["queue_wait_ms"] for e in epochs]))
    assert set(system.tracker.mapper.stage_s) == set(EPOCH_STAGES)


def test_scopes_nest_and_epochs_are_taken_once():
    rec = StageTimer()
    with rec.scope() as outer:
        with rec.stage("a"):
            rec.count("n", 2)
        with rec.epoch(7) as inner:
            with rec.stage("b"):
                rec.count("n")
    with rec.stage("a"):
        pass
    assert set(outer.spans_ns) == {"a", "b"} and outer.counts == {"n": 3}
    assert set(inner.spans_ns) == {"b"} and inner.counts == {"n": 1}
    assert rec.calls["a"] == 2 and rec.counters["n"] == 3
    (ep,) = rec.take_epochs()
    assert ep["kf_seq"] == 7 and set(ep["spans_ms"]) == {"b"} and ep["counts"] == {"n": 1}
    assert rec.take_epochs() == []
    since = rec.snapshot()
    assert rec.seconds(("a", "b"), since) == {} and rec.counted("n", since) == 0
    with rec.stage("b"):
        rec.count("n", 4)
    assert set(rec.seconds(("a", "b"), since)) == {"b"} and rec.counted("n", since) == 4


def test_record_totals_survive_many_threads():
    """Stress: more threads than cores, each in its own scope, add spans and
    counts with a 1 us switch interval: every thread's scope holds its own
    alone, and the totals lose no update."""
    rec = StageTimer()
    n_threads, n_iter = 16, 500
    scopes = [None] * n_threads

    def work(k):
        with rec.scope() as sc:
            for _ in range(n_iter):
                with rec.stage(f"t{k}"):
                    rec.count("n")
                    rec.count(f"c{k}", 2)
        scopes[k] = sc

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.counters["n"] == n_threads * n_iter
    for k, sc in enumerate(scopes):
        assert set(sc.spans_ns) == {f"t{k}"} and sc.counts == {"n": n_iter, f"c{k}": 2 * n_iter}
        assert rec.calls[f"t{k}"] == n_iter and rec.counters[f"c{k}"] == 2 * n_iter
