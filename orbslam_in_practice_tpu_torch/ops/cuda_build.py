"""Build and load the package's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source into one shared library with a
plain C interface for Hopper (``sm_90a``), under ``build/`` beside this
package, named by a hash of the sources and flags. ``ctypes`` loads it:
that build takes seconds, where one that includes PyTorch's headers takes
minutes. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu: pointers (host arrays of them, and the stream)
# as void*, counts as int
_SIGNATURES = {
    "fast_score_nms_levels": (_P, _P, _P, _I, _P),
    "orb_patch_features_levels": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P),
    "pose_optimization_launch": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/libkernels-<hash>.so`` unless it
    exists; returns its path. The compiler's output (``-Xptxas -v``:
    registers and shared memory per kernel) is kept beside it as ``.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The package's kernel library, built on first call, with its C entry
    points declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def host_array(ctype, values) -> ctypes.Array:
    """``values`` as a ctypes array in host memory (a C entry point's
    per-level pointers, shapes or prefix sums)."""
    values = list(values)
    return (ctype * len(values))(*values)


def check_cuda_tensor(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (None in ``shape`` matches any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
