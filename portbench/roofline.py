"""The work of the port's two CUDA kernels and the H100's peaks: the least
time each launch could take, whatever implements it.

Copied from ``orbslam_in_practice_tpu_torch/bench_kernels.py`` (``bound``,
``fast_arcs``, ``fast_work``, ``patch_work`` and their constants) and
``utils/profiling.py`` (the peaks), so that later changes to the program
leave the yardstick alone.

The peak for operations is the issue rate of float32 instructions, one
per lane a cycle: 132 SMs x 128 FP32 lanes x 1.98 GHz = 33.5 T/s (the data
sheet's 67 TFLOP/s counts an FMA as two). It is the right unit for both
kernels: kernel A's work is float32 subtractions, mins and maxes (its
compass test, arcs and NMS; only its one atomicMax an arc is an integer
instruction, and it is not counted), and kernel B's is float32 multiply-adds,
sums and compares. Bytes go at HBM3's 3.35 TB/s. Both are the SXM card's at
its full 700 W: a card set lower runs slower, so its power limit is printed
beside every share.
"""

from __future__ import annotations

import torch

FP32_OPS_PER_S = 67e12 / 2  # float32 instructions a second
BYTES_PER_S = 3.35e12  # HBM3

# kernel A's float instructions: the compass test (4 subtractions, 8
# comparisons) on each pixel of the 3 px interior; an arc of one polarity
# (16 FMAs for the margins, 48 min/max, 1 max with 0) for each polarity
# that passes the test; NMS on every pixel (12 max shared by a thread's 4
# outputs, then 2 max and 1 compare each: 6 a pixel)
FAST_OPS_TEST, FAST_OPS_ARC, FAST_OPS_NMS = 12, 65, 6
# kernel B's float ops a keypoint: a separable 7-tap blur of the 39x39
# window ((39*45 + 39*39) * 13), the moments (709 disc pixels x 2), 512
# rotated samples (~8 each)
PATCH_OPS_PER_KP = (39 * 45 + 39 * 39) * 13 + 709 * 2 + 512 * 8
PATCH_WINDOW_BYTES = 45 * 45 * 4
PATCH_OUT_BYTES = 8 + 4 + 32 + 256  # yx in; angle, words, ±1 row out


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds: the larger of ops at the float32 issue rate and
    bytes at HBM3's rate."""
    return max(ops / FP32_OPS_PER_S, nbytes / BYTES_PER_S)


def fast_arcs(img: torch.Tensor) -> tuple:
    """(brighter, darker): (H, W) bool masks of the pixels of the 3 px
    interior of ``img`` that pass kernel A's compass test for each
    polarity."""
    c = img[3:-3, 3:-3]
    m = [img[6:, 3:-3] - c, img[3:-3, 6:] - c, img[:-6, 3:-3] - c, img[3:-3, :-6] - c]  # compass 0, 4, 8, 12
    bright = torch.zeros_like(img, dtype=torch.bool)
    dark = torch.zeros_like(img, dtype=torch.bool)
    for k in range(4):
        a, b = m[k], m[(k + 1) % 4]
        bright[3:-3, 3:-3] |= (a > 0) & (b > 0)
        dark[3:-3, 3:-3] |= (a < 0) & (b < 0)
    return bright, dark


def fast_work(levels: list) -> tuple:
    """(ops, bytes) kernel A needs for these levels: the compass test on the
    interior, an arc for each polarity that passes it, NMS on every pixel;
    each pixel read once and written once."""
    ops = nbytes = 0
    for img in levels:
        h, w = img.shape
        arcs = sum(int(m.sum()) for m in fast_arcs(img))
        ops += (h - 6) * (w - 6) * FAST_OPS_TEST + arcs * FAST_OPS_ARC + h * w * FAST_OPS_NMS
        nbytes += img.numel() * 8
    return ops, nbytes


def patch_work(levels: list, n: int) -> tuple:
    """(ops, bytes) kernel B needs for ``n`` keypoints over these levels."""
    pyramid_bytes = sum(img.numel() for img in levels) * 4
    return n * PATCH_OPS_PER_KP, min(pyramid_bytes, n * PATCH_WINDOW_BYTES) + n * PATCH_OUT_BYTES + 256 * 16
