"""The unfused flow's second try from the reference keyframe, on the CPU.

``Tracking._track_frame`` tries the reference keyframe again when the local
map refutes the motion model's pose, or keeps under WEAK_INLIER_SHARE of
the frame before's inliers, and keeps the result with more local-map
inliers; a weak result of the fused step comes in as ``candidate``. The
stages are stubbed here: each returns a scripted outcome and sets the
tracker's pose, observations and inlier count as the real stage does.
"""

import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.slam.tracking import WEAK_INLIER_SHARE, Tracking, TrackingState

PREV_INLIERS = 400
WEAK = int(WEAK_INLIER_SHARE * PREV_INLIERS) - 1


def _pose(tag: float) -> torch.Tensor:
    T = torch.eye(4)
    T[0, 3] = tag
    return T


class _Script:
    """Scripted stages: ``motion`` and ``ref`` pass or fail; ``local`` is a
    list of the local map's inlier counts, one a call (a count under 30
    fails, as the real gate does)."""

    def __init__(self, tracker, motion: bool, ref: bool, local: list):
        self.t, self.motion, self.ref, self.local, self.calls = tracker, motion, ref, list(local), []

    def _track_with_motion_model(self, frame):
        self.calls.append("motion")
        if self.motion:
            self.t._prev_pose = self.t.last_pose
            self.t.last_pose, self.t.last_obs, self.t.n_inliers = _pose(1.0), np.array([1]), 50
        return self.motion

    def _track_reference_keyframe(self, frame):
        self.calls.append("ref")
        if self.ref:
            self.t._prev_pose = self.t.last_pose
            self.t.last_pose, self.t.last_obs, self.t.n_inliers = _pose(2.0), np.array([2]), 60
        return self.ref

    def _track_local_map(self, frame):
        self.calls.append("local")
        n = self.local.pop(0)
        if n < 30:
            return False
        self.t.n_inliers = n
        return True


@pytest.fixture
def tracker():
    t = Tracking(SlamConfig(n_features=64, n_levels=2, width=160, height=120, cx=80.0, cy=60.0, k_max=8,
                            l_max=256, enable_loop_closing=False), device="cpu")
    t.state = TrackingState.OK
    t.last_pose, t.last_obs, t.n_inliers, t.velocity = _pose(0.0), np.array([0]), PREV_INLIERS, torch.eye(4)
    t._need_new_keyframe = lambda frame: False
    return t


def _run(tracker, script, candidate=None):
    for name in ("_track_with_motion_model", "_track_reference_keyframe", "_track_local_map"):
        setattr(tracker, name, getattr(script, name))
    ok = tracker._track_frame(object(), candidate is None, candidate)
    return ok, float(tracker.last_pose[0, 3]), tracker.n_inliers


@pytest.mark.parametrize("motion,ref,local,calls,want", [
    # the motion model held by the local map: kept, the reference keyframe untried
    (True, True, [380], ["motion", "local"], (True, 1.0, 380)),
    # refuted: the reference keyframe's result
    (True, True, [12, 350], ["motion", "local", "ref", "local"], (True, 2.0, 350)),
    # barely held: the reference keyframe's, which keeps more inliers
    (True, True, [WEAK, 350], ["motion", "local", "ref", "local"], (True, 2.0, 350)),
    # barely held, and the reference keyframe fails: the motion model's
    (True, False, [WEAK], ["motion", "local", "ref"], (True, 1.0, WEAK)),
    # barely held, and the reference keyframe keeps fewer: the motion model's
    (True, True, [WEAK, WEAK - 5], ["motion", "local", "ref", "local"], (True, 1.0, WEAK)),
    # refuted, and the reference keyframe fails: lost
    (True, False, [12], ["motion", "local", "ref"], (False, None, None)),
    # the motion model fails: the reference keyframe, as before
    (False, True, [340], ["motion", "ref", "local"], (True, 2.0, 340)),
])
def test_second_try_from_the_reference_keyframe(tracker, motion, ref, local, calls, want):
    script = _Script(tracker, motion, ref, local)
    ok, pose, n = _run(tracker, script)
    assert script.calls == calls
    assert ok == want[0]
    if ok:
        assert (pose, n) == want[1:]
        # the velocity runs from the frame before's pose
        assert float(tracker.velocity[0, 3]) == pose
    else:
        assert tracker.state == TrackingState.LOST and tracker.velocity is None


@pytest.mark.parametrize("ref,local,want", [(True, [350], (2.0, 350)), (False, [], (3.0, WEAK)),
                                            (True, [WEAK - 5], (3.0, WEAK))])
def test_weak_fused_result_is_weighed_against_the_reference_keyframe(tracker, ref, local, want):
    script = _Script(tracker, True, ref, local)
    ok, pose, n = _run(tracker, script, candidate=(_pose(3.0), np.array([3]), WEAK))
    assert ok and (pose, n) == want
    assert "motion" not in script.calls
    assert float(tracker.velocity[0, 3]) == pose
