"""Real-dataset loaders: TUM RGB-D (monocular), KITTI odometry, EuRoC MAV.

Port of ``orbslam_in_practice_tpu/io/datasets.py`` (host numpy, the same
layouts and timestamp association). PGM/PPM frames decode with the native
loader (``io/native_loader.py``); PNG/JPG with PIL, else imageio.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _load_image_gray(path: str) -> np.ndarray:
    """One frame as float32 grayscale [0, 255]."""
    if path.endswith((".pgm", ".ppm", ".pnm")):
        from orbslam_in_practice_tpu_torch.io import native_loader

        img = native_loader.read_image(path)
        if img is not None:
            return img
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), dtype=np.float32)
    except ImportError:
        import imageio.v3 as iio

        img = iio.imread(path).astype(np.float32)
        return img @ np.array([0.299, 0.587, 0.114], np.float32) if img.ndim == 3 else img


@dataclass
class Sequence:
    """Timestamps and image paths; ground truth when available."""

    timestamps: np.ndarray  # (T,)
    image_paths: list
    gt_timestamps: np.ndarray | None = None  # (G,)
    gt_positions: np.ndarray | None = None  # (G, 3)
    gt_quats_xyzw: np.ndarray | None = None  # (G, 4)

    def __len__(self):
        return len(self.image_paths)

    def frames(self):
        """(timestamp, image) per frame, decoded as it is asked for."""
        for ts, p in zip(self.timestamps, self.image_paths):
            yield float(ts), _load_image_gray(p)

    def gt_positions_for_frames(self, max_dt: float = 0.05):
        """(frame indices, positions): ground truth associated to frames by
        nearest timestamp within ``max_dt`` (the TUM rule); (None, None)
        without ground truth."""
        if self.gt_timestamps is None:
            return None, None
        ids, pos = [], []
        for i, ts in enumerate(self.timestamps):
            j = int(np.argmin(np.abs(self.gt_timestamps - ts)))
            if abs(self.gt_timestamps[j] - ts) <= max_dt:
                ids.append(i)
                pos.append(self.gt_positions[j])
        return np.asarray(ids), np.asarray(pos, np.float32)


def _rows(path: str, sep: str | None = None) -> list:
    """Non-empty, non-comment lines of a text file, split."""
    with open(path) as f:
        return [line.split(sep) for line in (raw.strip() for raw in f) if line and not line.startswith("#")]


def load_tum(root: str) -> Sequence:
    """TUM RGB-D: rgb.txt ('ts path') + groundtruth.txt ('ts tx ty tz qx qy qz qw')."""
    rows = _rows(os.path.join(root, "rgb.txt"))
    gt_ts = gt_pos = gt_q = None
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        arr = np.asarray([[float(x) for x in r] for r in _rows(gt_file)])
        gt_ts, gt_pos, gt_q = arr[:, 0], arr[:, 1:4], arr[:, 4:8]
    return Sequence(
        np.asarray([float(r[0]) for r in rows]), [os.path.join(root, r[1]) for r in rows], gt_ts, gt_pos, gt_q
    )


def load_kitti(seq_dir: str, poses_file: str | None = None) -> Sequence:
    """KITTI odometry: image_0/*.png + times.txt (+ poses/XX.txt 3x4 rows)."""
    img_dir = os.path.join(seq_dir, "image_0")
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir) if f.endswith(".png"))
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"), dtype=np.float64)
    gt_ts = gt_pos = gt_q = None
    if poses_file and os.path.exists(poses_file):
        gt_pos = np.loadtxt(poses_file).reshape(-1, 3, 4)[:, :, 3]  # Twc rows
        gt_ts = times[: len(gt_pos)]
    return Sequence(times[: len(paths)], paths, gt_ts, gt_pos, gt_q)


def load_euroc(root: str) -> Sequence:
    """EuRoC MAV: mav0/cam0/data.csv + mav0/state_groundtruth_estimate0/data.csv."""
    rows = _rows(os.path.join(root, "mav0", "cam0", "data.csv"), ",")
    gt_csv = os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv")
    gt_ts = gt_pos = gt_q = None
    if os.path.exists(gt_csv):
        arr = np.asarray([[float(x) for x in r[:8]] for r in _rows(gt_csv, ",")])
        gt_ts, gt_pos, gt_q = arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:8]
    return Sequence(
        np.asarray([float(r[0]) * 1e-9 for r in rows]),
        [os.path.join(root, "mav0", "cam0", "data", r[1].strip()) for r in rows],
        gt_ts, gt_pos, gt_q,
    )
