"""Trajectory export in TUM and KITTI formats.

Port of ``orbslam_in_practice_tpu/io/trajectory.py`` (host numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.geometry.se3 import rot_to_quat


def save_tum(path: str, trajectory):
    """TUM format: 'timestamp tx ty tz qx qy qz qw' of Twc (camera in world)."""
    with open(path, "w") as f:
        for _, ts, Tcw in trajectory:
            if Tcw is None:
                continue
            Twc = np.linalg.inv(Tcw)
            q = rot_to_quat(torch.from_numpy(np.asarray(Twc[:3, :3], np.float32))).numpy()  # (w, x, y, z)
            t = Twc[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def save_kitti(path: str, trajectory):
    """KITTI format: 12 numbers per line, row-major 3x4 of Twc."""
    with open(path, "w") as f:
        for _, _, Tcw in trajectory:
            if Tcw is None:
                continue
            Twc = np.linalg.inv(Tcw)
            f.write(" ".join(f"{v:.7e}" for v in Twc[:3, :4].reshape(-1)) + "\n")
