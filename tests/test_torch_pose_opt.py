"""Pose-only BA's dispatch and its accepted-step counter on the CPU.

``pose_optimization`` runs its plain torch body for CPU tensors and never
touches the kernel's module (``ops/cuda_pose_opt.py``); the kernel's
wrapper refuses tensors off the card before it loads anything. Both
versions return the LM steps they accepted, and the tracker records them as
``lm_accepted`` on every fused frame and tracked unfused frame of
``run_slam --synthetic``. The card
half (the kernel against the plain version, its refusals) is in
``tests/test_torch_cuda.py``.
"""

import json

import pytest
import torch

from orbslam_in_practice_tpu_torch import run_slam
from orbslam_in_practice_tpu_torch.bench_kernels import pose_problem
from orbslam_in_practice_tpu_torch.ops import cuda_build, cuda_pose_opt
from orbslam_in_practice_tpu_torch.optim import pose_opt
from orbslam_in_practice_tpu_torch.optim.pose_opt import (
    ITERS_PER_ROUND,
    ROUNDS,
    pose_optimization,
    pose_optimization_plain,
)

torch.set_num_threads(2)
STEPS = ROUNDS * ITERS_PER_ROUND


def _refuse(*_, **__):
    raise AssertionError("the kernel's module was touched")


def test_cpu_tensors_never_touch_the_kernel(monkeypatch):
    monkeypatch.setattr(pose_opt, "pose_optimization_launch", _refuse)
    monkeypatch.setattr(cuda_pose_opt, "library", _refuse)
    monkeypatch.setattr(cuda_build, "library", _refuse)
    args = pose_problem(300, "cpu", seed=3)
    before = pose_optimization.launches
    got = pose_optimization(*args)
    assert pose_optimization.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, pose_optimization_plain(*args)))


def test_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(cuda_pose_opt, "library", _refuse)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_pose_opt.pose_optimization_launch(*pose_problem(16, "cpu"))


@pytest.mark.parametrize("case", [
    dict(n=400, seed=5),
    dict(n=400, seed=6, n_valid=0),
    dict(n=600, seed=7, rot_err=0.3, trans_err=1.5),
])
def test_plain_version_counts_accepted_steps(case):
    _, inlier, n_in, n_acc = pose_optimization(*pose_problem(device="cpu", **case))
    assert n_in.dtype == n_acc.dtype == torch.int64 and n_acc.dim() == 0
    assert int(n_in) == int(inlier.sum()) and 0 <= int(n_acc) <= STEPS
    if case.get("n_valid") == 0:
        assert int(n_acc) == 0 == int(n_in)
    else:
        assert int(n_acc) > 0 and int(n_in) > 0.3 * case["n"]


def test_run_slam_records_accepted_lm_steps(tmp_path):
    log = tmp_path / "log.jsonl"
    run_slam.main(["--synthetic", "--frames", "8", "--device", "cpu", "--log", str(log)])
    frames = [json.loads(line) for line in log.read_text().splitlines()]
    fused = [f for f in frames if f["path"] == "fused"]
    assert fused
    for f in fused:  # the fused step's two pose optimisations
        assert 0 < f["counts"]["lm_accepted"] <= 2 * STEPS, f
    for f in frames:  # the unfused flow's, after one or more
        if f["path"] == "unfused" and f["tracked"]:
            assert f["counts"]["lm_accepted"] > 0, f
