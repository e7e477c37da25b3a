"""Read the control beside the program on the card, at a cell's own size.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--seconds 30]
        [--fault-seeds 4 5 6 --faults skip_create skip_fuse]

For each seed, one run of the cell's set-up and a short window at its own
load, then the numbers of ``portbench/check.py`` twice: the program
against the reference, and the control (the reference in the nearest
lower precision: bfloat16 pyramid and blur, TF32 step, mapping stages and
BA) against the reference, and the faults ``check.faults`` plants in the
reference (a step, a BA and mapping stages that return their state
unchanged). The control has to come out not correct. Then, for each fault
seed and fault, a run with the fault planted in the program
(``FAULTS``: a keyframe epoch that makes no new points, or fuses
nothing), with its numbers, frames tracked and ATE. Prints one JSON line a
run. Benchmark runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from portbench.bench import load_cell
from portbench.check import judge
from portbench.harness import run_cell
from portbench.run import ROOT


def readings(workload: str, seed: int, seconds: float, device) -> dict:
    cell = load_cell(ROOT, workload)
    result, rows = run_cell(cell, seed, seconds, False, device, time.time(), control=True)
    ctl_ok, ctl_rows = judge(result["control"], cell.checks)
    return {"seed": seed, "program": {n: v for n, v, _ in rows}, "program_correct": result["correct"],
            "control": result["control"], "control_correct": ctl_ok, "faults": result["faults"],
            "limits": {n: lim for n, _, lim in rows},
            "attempted": result["attempted"], "info": result["info"]}


FAULTS = {
    "skip_create": ("create_new_points", lambda self, smap, kf_id: 0),
    "skip_fuse": ("fuse_neighbors", lambda self, smap, kf_id, neighbors=None: 0),
}


def fault_readings(workload: str, seed: int, seconds: float, device, fault: str) -> dict:
    """One run of the cell with ``fault`` planted in the local mapper."""
    from orbslam_in_practice_tpu_torch.slam.local_mapping import LocalMapper

    name, stub = FAULTS[fault]
    orig = LocalMapper.__dict__[name]
    setattr(LocalMapper, name, stub)
    try:
        result, rows = run_cell(load_cell(ROOT, workload), seed, seconds, False, device, time.time())
    finally:
        setattr(LocalMapper, name, orig)
    info = result["info"]
    return {"seed": seed, "fault": fault, "program": {n: v for n, v, _ in rows}, "correct": result["correct"],
            "attempted": result["attempted"], "frames_session0": info["frames_session0"],
            "tracked_session0": info["tracked_session0"], "ate_pct_session0": info["ate_pct_session0"],
            "info": info}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("portbench.control: needs a CUDA device")
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, torch.device("cuda", 0))), flush=True)
    for seed in args.fault_seeds:
        for fault in args.faults:
            print(json.dumps(fault_readings(args.workload, seed, args.seconds, torch.device("cuda", 0), fault)),
                  flush=True)


if __name__ == "__main__":
    main()
