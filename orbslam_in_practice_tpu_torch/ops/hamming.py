"""Packed BRIEF descriptors and Hamming distance as a matrix product.

Port of ``orbslam_in_practice_tpu/ops/hamming.py``, using the identity

    hamming(a, b) = (256 - <±1(a), ±1(b)>) / 2.

Packed descriptors are (..., 8) int32 words holding the bits of the JAX
package's uint32 words (bit j of word w is descriptor bit 32w + j), because
torch has no uint32 shifts on the CPU; ``.view(np.uint32)`` of the numpy
array recovers the reference's words.
"""

from __future__ import annotations

import numpy as np
import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} -> (..., 8) int32 (little-endian bit order)."""
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (8, 32))
    words = torch.sum(b << _shifts(bits.device), dim=-1)  # in [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 256) {0,1} uint8."""
    bits = (packed.to(torch.int64)[..., None] >> _shifts(packed.device)) & 1
    return bits.reshape(packed.shape[:-1] + (256,)).to(torch.uint8)


def unpack_to_pm1(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 256) int8 in {-1, +1}."""
    return unpack_bits(packed).to(torch.int8) * 2 - 1


def hamming_matrix(pm1_a: torch.Tensor, pm1_b: torch.Tensor) -> torch.Tensor:
    """(N, 256) int8 ±1, ([B,] M, 256) int8 ±1 -> ([B,] N, M) int32 Hamming
    distances.

    The dot product runs in float32, which is exact for ±1 sums of 256
    terms (TF32 is off package-wide); an int8 product would wrap on the CPU.
    """
    dot = pm1_a.to(torch.float32) @ pm1_b.to(torch.float32).transpose(-1, -2)
    return (256 - dot.to(torch.int32)) // 2


def hamming_np(packed_a: np.ndarray, packed_b: np.ndarray) -> np.ndarray:
    """The numpy golden model: (N, 8), (M, 8) packed words (this package's
    int32 or the JAX package's uint32, the same bits) -> (N, M) int32
    Hamming distances, by popcount of the XOR."""
    def bits(p):
        return np.unpackbits(np.ascontiguousarray(p).view(np.uint32).astype(">u4").view(np.uint8), axis=-1)

    a, b = bits(packed_a), bits(packed_b)
    return np.sum(a[:, None, :] != b[None, :, :], axis=-1).astype(np.int32)
