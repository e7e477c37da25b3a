"""The end-to-end arithmetic and the per-layer readers on recorded
fixtures."""

import json

import numpy as np
import pytest
import torch

from portbench import metrics
from portbench.harness import end_to_end
from portbench.roofline import bound_s, fast_work, patch_work
from portbench.trace import Records, Trace, breakdown

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]
SETTINGS = json.loads((ROOT / "portbench" / "configs" / "tum1.json").read_text())["settings"]


def _frame(s, i, ms, path="fused", kf=False, prof=False, stage_ms=None):
    return {"s": s, "i": i, "ms": ms, "path": path, "kf": kf, "pose": True, "stage_ms": stage_ms or {}, "prof": prof}


def test_frames_per_s_counts_the_whole_window():
    # two sessions; the window also holds the second system's construction
    # and the time between frames, which no frame's clock covers
    frames = [_frame(0, i, 100.0) for i in range(8)] + [_frame(1, i, 100.0, path="init") for i in range(2)]
    e2e = end_to_end(frames, window_s=2.5, setup_s=31.0)
    assert e2e["frames_per_s"] == pytest.approx(10 / 2.5)
    assert e2e["setup_s"] == 31.0


def test_frame_ms_p90_is_over_every_frame():
    # init, fused, keyframe and lost frames all count
    ms = [float(v) for v in range(1, 101)]
    paths = ["init"] * 5 + ["fused"] * 80 + ["unfused"] * 10 + ["reloc"] * 5
    frames = [_frame(0, i, m, path=p, kf=(i % 10 == 0)) for i, (m, p) in enumerate(zip(ms, paths))]
    assert end_to_end(frames, 10.0, 0.0)["frame_ms_p90"] == pytest.approx(np.percentile(ms, 90))
    assert end_to_end(frames, 10.0, 0.0)["frame_ms_p90"] == pytest.approx(90.1)


def _records():
    frames = [
        _frame(0, 0, 900.0, path="init"),
        _frame(0, 1, 300.0), _frame(0, 2, 320.0), _frame(0, 3, 700.0, kf=True,
                                                          stage_ms={"kf_fuse": 100.0, "kf_local_ba": 200.0,
                                                                    "kf_create": 50.0, "lc_detect": 1.0}),
        _frame(0, 4, 999.0, prof=True), _frame(0, 5, 999.0, prof=True),
        _frame(0, 6, 999.0, prof=True, kf=True, stage_ms={"kf_fuse": 5000.0}),
        _frame(0, 7, 800.0, kf=True, stage_ms={"kf_fuse": 300.0, "kf_local_ba": 100.0}),
    ]
    ms = 1_000_000
    tr = Trace(frames=[(0, 4, 0, 10 * ms), (0, 5, 10 * ms, 20 * ms), (0, 6, 20 * ms, 40 * ms)])
    tr.device = [("fast_score_nms_kernel(Levels)", 1 * ms, 20_000), ("orb_patch_kernel(Levels)", 2 * ms, 10_000),
                 ("aten::mm", 3 * ms, 1 * ms),
                 ("fast_score_nms_kernel(Levels)", 11 * ms, 20_000), ("orb_patch_kernel(Levels)", 12 * ms, 10_000),
                 ("aten::mm", 13 * ms, 2 * ms), ("aten::add", 14 * ms, 1 * ms),
                 ("aten::add", 25 * ms, 4 * ms)]
    tr.spans = [("pose_opt_motion", 3 * ms, 2 * ms), ("pose_opt_local", 5 * ms, 3 * ms),
                ("pose_opt_motion", 13 * ms, 1 * ms), ("pose_opt_local", 15 * ms, 1 * ms),
                ("pose_opt_local", 25 * ms, 9 * ms), ("kf_fuse", 30 * ms, 9 * ms)]
    tr.device.append(("aten::add", 31 * ms, 1 * ms))
    tr.ops = [("aten::item", 4 * ms, 5 * ms)]
    level = torch.full((64, 80), 10.0)
    level[20, 30] = 200.0
    return Records(frames=frames, trace=tr, settings=dict(SETTINGS, n_features=40, n_levels=1),
                   levels=lambda s, i: [level])


def read(name):
    return metrics.reader(name)(_records())


def test_fused_frame_ms_reads_untraced_fused_frames_without_an_epoch():
    assert read("fused_frame_ms") == pytest.approx(310.0)


def test_epoch_readers_average_the_untraced_epochs():
    assert read("epoch_ms") == pytest.approx(((100 + 200 + 50) + (300 + 100)) / 2)
    assert read("kf_fuse_ms") == pytest.approx(200.0)
    assert read("local_ba_ms") == pytest.approx(150.0)


def test_step_readers_read_the_traced_fused_frames():
    # frame 6's epoch (its kf_fuse span from 30 ms) is left out of its launches
    assert read("step_launches_per_frame") == pytest.approx((3 + 4 + 1) / 3)
    # pose optimisation's share of each frame's span up to its epoch
    # (frame 6's is cut at 30 ms): 5 of 10, 2 of 10 and 9 of 10 ms
    assert read("pose_opt_share") == pytest.approx(100 * (5 + 2 + 9) / 30)


@pytest.mark.parametrize("name", sorted(p.stem for p in metrics.DIR.glob("*.latency.py")))
def test_each_latency_twin_reads_as_its_metric(name):
    assert read(name) == read(name.removesuffix(".latency"))


def test_device_idle_is_the_uncovered_share_of_the_traced_span():
    busy = 0.02 + 0.01 + 1 + 0.02 + 0.01 + 2 + 4 + 1  # ms; the add at 14 ms lies inside the mm, counted once
    assert read("device_idle_pct") == pytest.approx(100 * (1 - busy / 40))


def test_roofline_readers_divide_the_bound_by_the_launch_time():
    rec = _records()
    lv = rec.levels(0, 4)
    assert read("fast_roofline") == pytest.approx(100 * 2 * bound_s(*fast_work(lv)) / 40e-6)
    assert read("patch_roofline") == pytest.approx(100 * 2 * bound_s(*patch_work(lv, 40)) / 20e-6)  # frame 6 has none


def test_readers_find_nothing_without_a_trace():
    rec = _records()
    rec.trace = None
    for name in ("step_launches_per_frame", "pose_opt_share", "fast_roofline", "patch_roofline",
                 "device_idle_pct"):
        assert metrics.reader(name)(rec) is None


def test_breakdown_names_device_ops_and_idle_gaps():
    b = breakdown(_records().trace)
    assert b["device_ops"][0][0] == "aten::add" and b["device_ops"][0][1] == pytest.approx(0.006)
    assert len(b["idle_gaps"]) <= 10 and all(v > 0 for _, v in b["idle_gaps"])
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(0.040 - 0.00806)
