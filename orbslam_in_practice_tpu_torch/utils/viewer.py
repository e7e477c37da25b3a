"""Offline map, trajectory and frame renderer.

Port of ``orbslam_in_practice_tpu/utils/viewer.py``: top-down and profile
views of the landmarks with the keyframe centres and the camera
trajectory, and a keypoint overlay of one frame, written as PNG files with
matplotlib's Agg backend (imported at first use). Host only: it reads the
map's numpy host truth and copies a frame's tensors to the host.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def render_map(slam_map, path: str, trajectory=None, title: str | None = None):
    """Landmarks, keyframe centres and an optional (T, 3) trajectory of
    camera centres, top-down (x-z) and in profile (x-y), to a PNG at
    ``path``. Returns ``path``."""
    plt = _plt()
    lm = slam_map.hview("lm_pos")[slam_map.lm_valid_host()]
    kf_pose = slam_map.hview("kf_pose")[slam_map.kf_valid_host()]
    centers = -np.einsum("kji,kj->ki", kf_pose[:, :3, :3], kf_pose[:, :3, 3]) if len(kf_pose) else np.zeros((0, 3))

    # display bounds from the cameras, so that one far outlier landmark
    # does not shrink the map to a dot
    refs = [p for p in (centers, None if trajectory is None else np.asarray(trajectory)) if p is not None and len(p)]
    anchor = np.concatenate(refs, axis=0) if refs else lm
    lims = None
    if len(anchor):
        lo, hi = np.percentile(anchor, 2, axis=0), np.percentile(anchor, 98, axis=0)
        span = np.maximum(hi - lo, 1e-3)
        lims = (lo - 1.5 * span - 1.0, hi + 1.5 * span + 1.0)

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    for ax, (i, j, name) in zip(axes, [(0, 2, "top-down (x-z)"), (0, 1, "profile (x-y)")]):
        if len(lm):
            keep = np.all((lm >= lims[0]) & (lm <= lims[1]), axis=1) if lims is not None else np.ones(len(lm), bool)
            shown = lm[keep]
            ax.scatter(shown[:, i], shown[:, j], s=1.0, c="#9aa0a6", label=f"{len(shown)}/{len(lm)} landmarks")
        if trajectory is not None and len(trajectory):
            tr = np.asarray(trajectory)
            ax.plot(tr[:, i], tr[:, j], "-", color="#1a73e8", lw=1.0, label="trajectory")
        if len(centers):
            ax.plot(centers[:, i], centers[:, j], "o", color="#d93025", ms=3.0, label=f"{len(centers)} keyframes")
        if lims is not None:
            ax.set_xlim(lims[0][i], lims[1][i])
            ax.set_ylim(lims[0][j], lims[1][j])
        ax.set_xlabel(name.split()[1][1])
        ax.set_title(name)
        ax.set_aspect("equal", adjustable="datalim")
        ax.legend(loc="best", fontsize=8)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def render_frame(image, frame, path: str, matches=None, title: str | None = None):
    """Keypoint overlay of one frame: image (H, W) grayscale, frame a Frame
    (xy, valid); matches an optional bool mask over its features (drawn
    green, the rest grey). Returns ``path``."""
    plt = _plt()
    img = _np(image)
    xy, valid = _np(frame.xy), _np(frame.valid)
    fig, ax = plt.subplots(figsize=(img.shape[1] / 100, img.shape[0] / 100), dpi=100)
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    if matches is not None:
        m = _np(matches) & valid
        ax.plot(xy[valid & ~m, 0], xy[valid & ~m, 1], ".", color="#9aa0a6", ms=2)
        ax.plot(xy[m, 0], xy[m, 1], ".", color="#34a853", ms=3)
    else:
        ax.plot(xy[valid, 0], xy[valid, 1], ".", color="#34a853", ms=2)
    ax.set_axis_off()
    if title:
        ax.set_title(title)
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
    return path
