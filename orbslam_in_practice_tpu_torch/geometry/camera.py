"""Pinhole camera with radial-tangential distortion, batched torch.

Port of ``orbslam_in_practice_tpu/geometry/camera.py``: the intrinsics
record, ``project`` / ``unproject``, radtan ``distort_radtan``, the
10-iteration fixed-point ``undistort_points`` (the scheme
cv::undistortPoints uses) and the undistorted image bounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraIntrinsics(NamedTuple):
    """Static intrinsics shared by all frames."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple  # (k1, k2, p1, p2, k3)
    width: int
    height: int

    def K(self, device: torch.device | str = "cpu") -> torch.Tensor:
        """(3, 3) float32 intrinsic matrix on ``device``."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
            device=device,
        )

    def dist_tensor(self, device: torch.device | str = "cpu") -> torch.Tensor:
        """(5,) float32 distortion coefficients (k1, k2, p1, p2, k3)."""
        return torch.tensor(self.dist, dtype=torch.float32, device=device)

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 1e-12 for d in self.dist)


def project(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> undistorted pixels (..., 2)."""
    z = pts_cam[..., 2:3]
    xy = pts_cam[..., :2] / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)


def distort_radtan(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion (k1, k2, p1, p2, k3) to normalized coords
    (..., 2)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def unproject(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalized image-plane coords (..., 2)."""
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y], dim=-1)


def undistort_points(
    K: torch.Tensor, dist: torch.Tensor, uv: torch.Tensor, iters: int = 10
) -> torch.Tensor:
    """Undistort pixel points (..., 2) -> undistorted pixel points (..., 2).

    A fixed number of fixed-point iterations; returns pixel coordinates
    re-projected through K.
    """
    xy_d = unproject(K, uv)
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xy_d[..., 0] - dx) / radial, (xy_d[..., 1] - dy) / radial], dim=-1)
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)


def compute_image_bounds(cam: CameraIntrinsics) -> tuple:
    """Undistorted image bounds (min_x, max_x, min_y, max_y): the extremes
    of the four undistorted corners (the image itself without distortion)."""
    if not cam.has_distortion:
        return 0.0, float(cam.width), 0.0, float(cam.height)
    corners = torch.tensor(
        [[0.0, 0.0], [cam.width, 0.0], [0.0, cam.height], [cam.width, cam.height]], dtype=torch.float32
    )
    und = undistort_points(cam.K(), cam.dist_tensor(), corners)
    return float(und[:, 0].min()), float(und[:, 0].max()), float(und[:, 1].min()), float(und[:, 1].max())
