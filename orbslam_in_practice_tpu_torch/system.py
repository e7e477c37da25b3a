"""SlamSystem: the API facade.

Port of ``orbslam_in_practice_tpu/system.py``: construct from a settings
file or a ``SlamConfig`` (and, by keyword, a device), feed monocular
frames, get poses back, export the trajectory, save and load the map (the JAX package's npz
format, so a map saved by either package loads in the other). With
``async_mapping`` the mapping epochs run in a worker thread: ``wait_idle``
waits for it, ``shutdown`` stops it, and reading the trajectory or saving
the map waits for it first.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.config import SlamConfig, load_config
from orbslam_in_practice_tpu_torch.slam.tracking import Tracking, TrackingState, materialize_trajectory


class SlamSystem:
    def __init__(self, config, bow_path: str | None = None, *, device: torch.device | str = "cuda"):
        """config: path to an ORB-SLAM style YAML or a SlamConfig; bow_path:
        the reference's vocabulary file, accepted and ignored as in the JAX
        package (place recognition needs no vocabulary); device: where the
        map and every device stage live."""
        if isinstance(config, str):
            config = load_config(config)
        self.cfg: SlamConfig = config
        self.tracker = Tracking(config, device)

    def track_monocular(self, image, timestamp: float):
        """Feed one frame, grayscale (H, W) or colour (H, W, 3) in [0, 255];
        returns Tcw (4, 4) numpy or None."""
        img = np.asarray(image, np.float32)
        if img.ndim == 3:  # RGB or BGR -> gray
            w = [0.299, 0.587, 0.114] if self.cfg.rgb else [0.114, 0.587, 0.299]
            img = img @ np.array(w, np.float32)
        return self.tracker.track_mono(img, timestamp)

    Trackmonocular = track_monocular  # the reference's spelling

    @property
    def state(self) -> TrackingState:
        return self.tracker.state

    @property
    def map(self):
        return self.tracker.map

    def reset(self):
        self.tracker.reset()

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Wait until the mapping worker has applied every queued epoch
        (True at once in synchronous mode); False when ``timeout`` ran out.
        Re-raises a worker error."""
        driver = self.tracker.async_driver
        return True if driver is None else driver.drain(timeout)

    def shutdown(self, timeout: float = 60.0):
        """Drain and join the mapping worker (ORB-SLAM's System::Shutdown);
        nothing to do in synchronous mode."""
        if self.tracker.async_driver is not None:
            self.tracker.async_driver.shutdown(timeout)

    def get_trajectory(self):
        """[(frame_id, timestamp, Tcw 4x4 numpy or None), ...], re-anchored
        to the current keyframe poses."""
        return materialize_trajectory(self.tracker)

    def save_trajectory_tum(self, path: str):
        from orbslam_in_practice_tpu_torch.io.trajectory import save_tum

        save_tum(path, self.get_trajectory())

    def save_trajectory_kitti(self, path: str):
        from orbslam_in_practice_tpu_torch.io.trajectory import save_kitti

        save_kitti(path, self.get_trajectory())

    def save_map(self, path: str):
        from orbslam_in_practice_tpu_torch.utils.checkpoint import save_map

        self.wait_idle()
        save_map(path, self.tracker.map)

    def load_map(self, path: str):
        """Replace the tracker's map with the one saved at ``path``."""
        from orbslam_in_practice_tpu_torch.utils.checkpoint import load_map

        self.wait_idle()
        self.tracker.adopt_map(load_map(path, self.tracker.device))
