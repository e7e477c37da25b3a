"""The roofline of one NVIDIA H100.

The JAX package's ``utils/profiling.py`` reads XLA's cost analysis and a
TPU v5e's peaks. Here the caller counts the work (PyTorch has no cost
analysis to read), and the peaks are the H100 SXM's from NVIDIA's data
sheet, at its full 700 W power limit: a card set lower runs slower.
"""

from __future__ import annotations

# float32 outside the tensor cores, an FMA counted as 2 flops
FP32_FLOPS_PER_S = 67e12
# float instructions a second (an FMA, a subtraction, a min or a compare
# each count once): 132 SMs x 128 lanes x 1.98 GHz
OPS_PER_S = FP32_FLOPS_PER_S / 2
BYTES_PER_S = 3.35e12  # HBM3


def speed_of_light_report(flops: float, bytes_accessed: float, peak_flops: float = FP32_FLOPS_PER_S,
                          peak_bw: float = BYTES_PER_S) -> dict:
    """Roofline lower bound of work that does ``flops`` and moves
    ``bytes_accessed`` (each input read once, each output written once),
    at the H100's float32 and HBM3 peaks by default."""
    t_compute, t_memory = flops / peak_flops, bytes_accessed / peak_bw
    return {
        "flops": float(flops),
        "bytes_accessed": float(bytes_accessed),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_lower_bound_s": max(t_compute, t_memory),
        "bound_by": "operations" if t_compute >= t_memory else "bytes",
    }
