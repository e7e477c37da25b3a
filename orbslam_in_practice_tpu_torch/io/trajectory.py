"""Trajectory export in TUM and KITTI formats.

Port of ``orbslam_in_practice_tpu/io/trajectory.py`` (host numpy).
"""

from __future__ import annotations

import numpy as np


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (3, 3) -> unit quaternion (w, x, y, z) with w >= 0,
    from the candidate of the largest diagonal term."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        t = 1.0 + tr
        q = [t, m21 - m12, m02 - m20, m10 - m01]
    elif m00 > m11 and m00 > m22:
        t = 1.0 + m00 - m11 - m22
        q = [m21 - m12, t, m01 + m10, m02 + m20]
    elif m11 > m22:
        t = 1.0 + m11 - m00 - m22
        q = [m02 - m20, m01 + m10, t, m12 + m21]
    else:
        t = 1.0 + m22 - m00 - m11
        q = [m10 - m01, m02 + m20, m12 + m21, t]
    q = np.asarray(q, np.float32) / np.sqrt(max(4.0 * t, 1e-8))
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def save_tum(path: str, trajectory):
    """TUM format: 'timestamp tx ty tz qx qy qz qw' of Twc (camera in world)."""
    with open(path, "w") as f:
        for _, ts, Tcw in trajectory:
            if Tcw is None:
                continue
            Twc = np.linalg.inv(Tcw)
            q = rot_to_quat(Twc[:3, :3])
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
