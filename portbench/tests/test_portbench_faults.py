"""The check catches the faults a cell of this system can have: the run's
own path, on the CPU at a small size, with the timed path broken
underneath. (No batch and no exchange between chips here: a frame is one
camera's, on one card.)"""

import time

import pytest
import torch

from portbench.harness import run_cell
from portbench.tests.tiny import tiny_cell

SECONDS = 25.0


def _run(seed=7):
    torch.set_num_threads(4)
    return run_cell(tiny_cell(), seed, SECONDS, False, torch.device("cpu"), time.time())


def test_a_sound_run_is_correct():
    result, rows = _run()
    assert result["correct"], rows
    samples = result["info"]["samples"]
    assert samples["steps"] >= 1 and samples["bas"] >= 1 and samples["creates"] >= 1 and samples["fuses"] >= 1
    assert result["info"]["tri_made"] > 0 and result["info"]["fuse_changed"] > 0


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    from orbslam_in_practice_tpu_torch.slam import tracking

    forward = tracking.FusedSteadyStep.forward

    def stale(self, image, packed_ids, velocity, last_pose, *tables):
        frame, _, obs, vel, ok1, ok, n2 = forward(self, image, packed_ids, velocity, last_pose, *tables)
        return frame, last_pose, obs, vel, ok1, ok, n2

    monkeypatch.setattr(tracking.FusedSteadyStep, "forward", stale)
    result, rows = _run()
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in rows)["pose_px"] > 0.1


def test_a_descriptor_altered_where_it_is_produced_is_caught(monkeypatch):
    from orbslam_in_practice_tpu_torch.frontend import orb

    forward = orb.ORBExtractor.forward

    def flipped(self, image):
        f = forward(self, image)
        pm1 = f.desc_pm1.clone()
        pm1[::10, 0] = -pm1[::10, 0]
        return f._replace(desc_pm1=pm1)

    monkeypatch.setattr(orb.ORBExtractor, "forward", flipped)
    result, rows = _run()
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in rows)["kp_diff"] > 0.05


def test_a_bundle_adjustment_that_returns_its_input_is_caught(monkeypatch):
    from orbslam_in_practice_tpu_torch.slam import local_mapping

    solve = local_mapping.bundle_adjustment

    def unchanged(prob, *args, **kwargs):
        _, _, chi2 = solve(prob, *args, **kwargs)
        return prob.poses, prob.points, chi2

    monkeypatch.setattr(local_mapping, "bundle_adjustment", unchanged)
    result, rows = _run()
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in rows)["ba_short"] == pytest.approx(1.0)


def test_an_epoch_that_makes_no_new_points_is_caught(monkeypatch):
    from orbslam_in_practice_tpu_torch.slam import local_mapping

    monkeypatch.setattr(local_mapping.LocalMapper, "create_new_points", lambda self, smap, kf_id: 0)
    result, rows = _run()
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in rows)["tri_diff"] == pytest.approx(1.0)


def test_a_point_altered_where_it_is_triangulated_is_caught(monkeypatch):
    from orbslam_in_practice_tpu_torch.slam import local_mapping

    triangulate = local_mapping._triangulate_pairs

    def moved(*args):
        Xw, accept = triangulate(*args)
        return Xw * 1.01, accept

    monkeypatch.setattr(local_mapping, "_triangulate_pairs", moved)
    result, rows = _run()
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in rows)["tri_px"] > 0.05


def test_an_epoch_that_fuses_nothing_is_caught(monkeypatch):
    from orbslam_in_practice_tpu_torch.slam import local_mapping

    monkeypatch.setattr(local_mapping.LocalMapper, "fuse_neighbors", lambda self, smap, kf_id, neighbors=None: 0)
    result, rows = _run()
    assert not result["correct"]
    assert dict((n, v) for n, v, _ in rows)["fuse_diff"] == pytest.approx(1.0)


@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card(cuda_device):
    """The control at a cell's own size, one seed and a short window (the
    PR's readings took three seeds and more: ``portbench/control.py``)."""
    from portbench.control import readings

    r = readings("tum1.xyz", 2**31 + 101, 20.0, cuda_device)
    assert r["program_correct"]
    assert not r["control_correct"]
