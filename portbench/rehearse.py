"""Rehearse cells on the CPU: the harness end to end with the port's
plain paths (its CUDA kernels run only on the card), on several seeds.

    python -m portbench.rehearse --workload <cell> --seeds 1 2 3 [--seconds 60] [--session N] [--trace 0|1]

Prints one JSON line a seed: the result without device metrics (a CPU
time is no device number), the compared numbers, and what the window saw.
``--session`` cuts the session's frames (a small size for the CPU).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from portbench.bench import load_cell
from portbench.harness import run_cell
from portbench.run import ROOT


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--session", type=int, default=0, help="frames of a session (0: the mix's)")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    for seed in args.seeds:
        cell = load_cell(ROOT, args.workload)
        if args.session:
            cell.mix["session_frames"] = args.session
            cell.mix["warmup"]["frames"] = min(cell.mix["warmup"]["frames"], args.session)
        result, rows = run_cell(cell, seed, args.seconds, bool(args.trace), torch.device("cpu"), time.time())
        result.pop("metrics")
        print(json.dumps({"seed": seed, "checks": {n: [v, lim] for n, v, lim in rows}, **result}), flush=True)


if __name__ == "__main__":
    main()
