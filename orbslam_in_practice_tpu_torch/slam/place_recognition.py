"""Global place-recognition descriptors.

Port of the descriptor half of
``orbslam_in_practice_tpu/slam/place_recognition.py``: a keyframe's
descriptor is the L2-normalised mean of its valid ±1 BRIEF vectors,
computed once when the keyframe is inserted. Raw cosines between such
descriptors crowd near 1, so scores are taken after ``center``.
"""

from __future__ import annotations

import numpy as np
import torch

GDESC_DIM = 256


def global_descriptor(desc_pm1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(F, 256) ±1 descriptors + (F,) validity -> (256,) L2-normalised mean
    descriptor. Invalid features contribute nothing."""
    d = desc_pm1.to(torch.float32)
    v = valid.to(torch.float32)[:, None]
    m = torch.sum(d * v, dim=0) / torch.clamp(torch.sum(v), min=1.0)
    return m / torch.clamp(torch.linalg.vector_norm(m), min=1e-9)


def center(G: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Subtract the mean over valid rows and L2-renormalise (host-side)."""
    rows = G[valid]
    if len(rows) == 0:
        return G
    Gc = G - rows.mean(axis=0, keepdims=True)
    return Gc / np.maximum(np.linalg.norm(Gc, axis=1, keepdims=True), 1e-9)
