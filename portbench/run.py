"""Run one benchmark cell once on the card and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix and limits are files under ``portbench/``.
The run renders the session's frames from ``--seed``, warms the system up
on a throwaway session, measures closed-loop sessions of ``SlamSystem``
for ``--seconds``, and checks what the timed path produced against the
plain reference (``portbench/check.py``). ``--trace 1`` profiles a bounded
run of frames and prints the per-layer metrics instead of the end-to-end
ones.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (frames handed to ``track_monocular`` in the window),
``failed`` (frames that got no pose after their session's map was
initialised; every frame of a session that never initialised), ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, then ``info`` and, last,
``checks``: each compared number beside its limit, also printed as the last
lines of standard error.

Exits 2 without a result when there is no CUDA device (or fewer than the
cell asks for), and 3 when JAX or the JAX package is loaded at the end.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"  # build and kernel caches, inside the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam_in_practice_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"

    from portbench.bench import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} here", file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    device = torch.device("cuda", 0)
    result, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
                        **result["device"]}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    print(json.dumps(result))
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
