"""The one traffic generator: a mix's data file, the configuration's
camera and the run's seed make the session's scene and trajectory.

A mix (``portbench/traffic/<mix>.json``) holds:

- ``scene``: the world (``world_seed``, which lays it out; ``kind``:
  ``box``, the port's textured-quad box around the path, or ``corridor``,
  its street corridor; ``points`` or
  ``points_per_frame``; ``depth_range``, ``spread``, ``size_range``,
  ``noise_sigma``, ``brightness_jitter``, optionally ``texture`` and
  ``psf_sigma``);
- ``motion``: the camera path (``kind``: ``hover`` with
  ``trans_speed_m_per_s``, ``rot_speed_deg_per_s``, ``axis_period_frames``,
  ``yaw_period_frames``, ``pitch_period_frames``; or one of the port's
  kinds, ``kitti_loop``, ``kitti``, ``strafe``, ``forward``, ``rotation``,
  with ``step_m``, metres a frame);
- ``session_frames``: L, the frames of one session;
- ``warmup``: the throwaway session before the clock, its first
  ``frames`` frames (through initialisation and a keyframe epoch);
- ``check``: which session frames and keyframe epochs the correctness
  check samples;
- ``trace``: the stretch of a session (``first_frame``, ``frames``) that
  a ``--trace 1`` run replays under the profiler once its window has
  closed.

The camera (size, focal lengths, principal point, distortion, frame rate)
is the configuration's. The run's ``--seed`` draws every frame's exposure
gain and sensor noise; the world is the mix's own (``world_seed``), so
every seed gives the system the same work in other noise: with the world
drawn from the seed too, one seed's work differed from another's by more
than a bound can hold (measured on one H100; PERF.md).
"""

from __future__ import annotations

import numpy as np

from portbench.scene import SyntheticSequence, hover_trajectory, make_trajectory


def build_sequence(mix: dict, settings: dict, seed: int) -> SyntheticSequence:
    """The session's ``SyntheticSequence``: ``mix``'s world and motion seen
    through ``settings``' camera, its noise drawn from ``seed``."""
    n = int(mix["session_frames"])
    scene, motion = mix["scene"], mix["motion"]
    fps = float(settings["fps"])
    if motion["kind"] == "hover":
        poses = hover_trajectory(
            n, motion["trans_speed_m_per_s"] / fps, np.deg2rad(motion["rot_speed_deg_per_s"]) / fps,
            int(motion["axis_period_frames"]), int(motion["yaw_period_frames"]),
            int(motion["pitch_period_frames"]),
        )
    else:
        poses = make_trajectory(n, motion["kind"], step=float(motion["step_m"]))
    if scene["kind"] == "corridor":
        if motion["kind"] not in ("kitti", "kitti_loop"):
            raise ValueError("a corridor scene follows a kitti or kitti_loop path")
        kind, n_points = motion["kind"], int(scene["points_per_frame"]) * n
    elif scene["kind"] == "box":
        kind, n_points = "box", int(scene["points"])
    else:
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    return SyntheticSequence(
        n_frames=n, n_points=n_points, width=int(settings["width"]), height=int(settings["height"]),
        fx=float(settings["fx"]), fy=float(settings["fy"]), cx=float(settings["cx"]), cy=float(settings["cy"]),
        kind=kind, seed=int(scene["world_seed"]), noise_seed=int(seed), depth_range=tuple(scene["depth_range"]),
        spread=tuple(scene["spread"]),
        size_range=tuple(scene["size_range"]), noise_sigma=float(scene["noise_sigma"]),
        brightness_jitter=float(scene["brightness_jitter"]), texture=float(scene.get("texture", 0.45)),
        psf_sigma=float(scene.get("psf_sigma", 0.8)),
        dist=tuple(float(settings[k]) for k in ("k1", "k2", "p1", "p2", "k3")), poses=poses,
    )
