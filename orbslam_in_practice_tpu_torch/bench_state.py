"""Tracking state for the fused step on a rendered scene.

Port of ``__graft_entry__._build_bench_state``, parametrised by the config:
landmarks are the frame-0 ORB features associated with the scene's exact 3D
points (true descriptors, normals and distance invariants) and the velocity
is the ground-truth one, so every stage of the step does its full work.

``state_from_numpy`` turns the step's 11 arguments, as numpy arrays (for
example those of the JAX package's step), into this package's tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.config import SlamConfig
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch.slam.tracking import LOCAL_MAP_MAX, FusedSteadyStep, encode_image

# the step's arguments after the image, packed ids, velocity and last pose
_TABLE_DTYPES = (
    torch.float32,  # lm_pos (l_max, 3)
    torch.int8,  # lm_desc (l_max, 256) ±1
    torch.bool,  # lm_valid (l_max,)
    torch.int32,  # lm_oct (l_max,)
    torch.float32,  # lm_normal (l_max, 3)
    torch.float32,  # lm_mind (l_max,)
    torch.float32,  # lm_maxd (l_max,)
)


def bench_config() -> SlamConfig:
    """The configuration the repository's benchmark measures: 640x480,
    512 features over 4 levels, a 16384-slot landmark table."""
    return SlamConfig(n_features=512, n_levels=4, width=640, height=480)


def state_from_numpy(args, device: torch.device | str) -> tuple:
    """The step's 11 arguments as numpy arrays -> tensors on ``device``:
    uint16 image, int32 packed ids, float32 poses, then the landmark tables
    as float32 positions, int8 descriptors, bool validity, int32 octaves and
    float32 normals and distance bounds."""
    image, packed, velocity, last_pose, *tables = (np.asarray(a) for a in args)
    if image.dtype != np.uint16:
        raise ValueError(f"image must be 8.8 fixed-point uint16, got {image.dtype}")
    head = (
        torch.from_numpy(image),
        torch.from_numpy(packed.astype(np.int32)),
        torch.from_numpy(velocity.astype(np.float32)),
        torch.from_numpy(last_pose.astype(np.float32)),
    )
    tail = tuple(
        torch.from_numpy(np.ascontiguousarray(t)).to(dtype) for t, dtype in zip(tables, _TABLE_DTYPES)
    )
    return tuple(t.to(device) for t in head + tail)


def bench_arrays(cfg: SlamConfig, step: FusedSteadyStep, n_images: int = 1, n_points: int = 900):
    """Render the strafe scene and build the step's state as numpy arrays.

    Returns (args, images, seq): args are the 11 step arguments for frame 1,
    images (n_images, H, W) uint16 are frames 1..n_images, seq the scene.
    """
    device = step.K.device
    seq = SyntheticSequence(
        n_frames=max(n_images + 1, 2), n_points=n_points, width=cfg.width,
        height=cfg.height, fx=cfg.fx, fy=cfg.fy, kind="strafe", seed=0,
    )
    with torch.no_grad():
        frame0 = step.extractor(torch.from_numpy(seq.render(0)).to(device))
    xy0 = frame0.xy.cpu().numpy()
    valid0 = frame0.valid.cpu().numpy()
    desc0 = frame0.desc_pm1.cpu().numpy()
    oct0 = frame0.octave.cpu().numpy()

    # exact 3D for each detected feature: ray-cast its pixel against the
    # renderer's depth buffer
    T0 = seq.poses[0]
    X_w, bp_valid = seq.backproject(0, xy0)
    feat_ids = np.nonzero(valid0 & bp_valid)[0]
    n_lm = len(feat_ids)

    l_max, f_max = cfg.l_max, step.f_max
    lm_pos = np.zeros((l_max, 3), np.float32)
    lm_pos[:n_lm] = X_w[feat_ids]
    lm_desc = np.zeros((l_max, 256), np.int8)
    lm_desc[:n_lm] = desc0[feat_ids]
    lm_oct = np.zeros(l_max, np.int32)
    lm_oct[:n_lm] = oct0[feat_ids]
    lm_valid = np.zeros(l_max, bool)
    lm_valid[:n_lm] = True
    cam0 = -(T0[:3, :3].T @ T0[:3, 3])
    vec = lm_pos[:n_lm] - cam0
    dist = np.linalg.norm(vec, axis=-1)
    normal = np.zeros((l_max, 3), np.float32)
    normal[:n_lm] = vec / np.maximum(dist, 1e-6)[:, None]
    min_d = np.full(l_max, 0.1, np.float32)
    max_d = np.full(l_max, 100.0, np.float32)
    min_d[:n_lm] = dist / 3.0
    max_d[:n_lm] = dist * 3.0

    # one packed id array: [mm_ids | loc_ids | mm_n | loc_n]
    packed = np.zeros(f_max + LOCAL_MAP_MAX + 2, np.int32)
    packed[: min(n_lm, f_max)] = np.arange(min(n_lm, f_max))
    packed[f_max : f_max + min(n_lm, LOCAL_MAP_MAX)] = np.arange(min(n_lm, LOCAL_MAP_MAX))
    packed[f_max + LOCAL_MAP_MAX] = min(n_lm, f_max)
    packed[f_max + LOCAL_MAP_MAX + 1] = min(n_lm, LOCAL_MAP_MAX)

    velocity = (seq.poses[1] @ np.linalg.inv(T0)).astype(np.float32)
    images = np.stack([encode_image(seq.render(1 + i)) for i in range(n_images)])
    args = (images[0], packed, velocity, T0, lm_pos, lm_desc, lm_valid, lm_oct, normal, min_d, max_d)
    return args, images, seq


def build_bench_state(
    cfg: SlamConfig | None = None,
    n_images: int = 1,
    device: torch.device | str = "cuda",
    use_kernels: bool = True,
    n_points: int = 900,
):
    """Returns (step, args, images, seq): the step module on ``device``, its
    11 arguments for frame 1 as tensors, the uint16 frames 1..n_images
    (numpy) and the scene with its ground-truth poses."""
    cfg = cfg if cfg is not None else bench_config()
    step = FusedSteadyStep(cfg, use_kernels=use_kernels).to(device)
    args, images, seq = bench_arrays(cfg, step, n_images, n_points)
    return step, state_from_numpy(args, device), images, seq
