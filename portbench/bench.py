"""What ``BENCHMARK.json`` says of one cell, found by name.

A cell names a configuration and a traffic mix; each lives in files of its
own under ``portbench/``: ``configs/<file>`` (given in the configuration's
entry), ``traffic/<mix>.json`` and ``checks/<cell>.json`` (the limits of
the numbers that decide ``correct``). Per-layer metrics are
``metrics/<name>.py``. Nothing here lists names: a new cell, configuration,
mix or metric is new files and new ``BENCHMARK.json`` entries.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file: source, settings, reduced, assumed
    mix: dict  # the traffic mix's file
    checks: dict  # number name -> {"limit": ...}
    end_to_end: list  # BENCHMARK.json entries reported by this cell with --trace 0
    per_layer: list  # and with --trace 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError for a
    name the file does not hold."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text()),
        checks=json.loads((PKG / "checks" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
