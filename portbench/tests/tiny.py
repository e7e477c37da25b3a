"""A small cell for the CPU tests: the xyz hover through a 320x240 TUM1
camera at 500 features over 4 levels, with short sessions."""

import copy
import json
from pathlib import Path

from portbench.bench import Cell

PKG = Path(__file__).resolve().parents[1]


def tiny_cell() -> Cell:
    config = json.loads((PKG / "configs" / "tum1.json").read_text())
    s = config["settings"]
    s.update(width=320, height=240, fx=s["fx"] / 2, fy=s["fy"] / 2, cx=s["cx"] / 2, cy=s["cy"] / 2, n_features=500,
             n_levels=4, k_max=64, l_max=4096)
    mix = json.loads((PKG / "traffic" / "xyz.json").read_text())
    mix.update(session_frames=60, warmup={"frames": 20},
               check=dict(mix["check"], after_first_pose=[3, 20], step_samples=3, extract_samples=2),
               trace={"first_frame": 10, "frames": 3})
    checks = json.loads((PKG / "checks" / "tum1.xyz.json").read_text())
    return Cell(name="tiny", chips=1, config=config, mix=copy.deepcopy(mix), checks=checks, end_to_end=[],
                per_layer=[])
