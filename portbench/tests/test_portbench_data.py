"""A cell, a configuration, a traffic mix and a per-layer metric are data:
a copy of the benchmark runs a fixture cell added as new files and new
``BENCHMARK.json`` entries alone, with no file of the harness edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def test_a_fixture_cell_runs_from_data_alone(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = tmp_path / "portbench"
    conf = json.loads((new / "configs" / "tum1.json").read_text())
    s = conf["settings"]
    s.update(width=320, height=240, fx=s["fx"] / 2, fy=s["fy"] / 2, cx=s["cx"] / 2, cy=s["cy"] / 2,
             n_features=500, n_levels=4, k_max=64, l_max=4096)
    conf["name"] = "tiny_cam"
    (new / "configs" / "tiny_cam.json").write_text(json.dumps(conf))
    mix = json.loads((new / "traffic" / "xyz.json").read_text())
    mix.update(session_frames=40, warmup={"frames": 15},
               check=dict(mix["check"], after_first_pose=[3, 12], step_samples=2, extract_samples=2),
               trace={"first_frame": 8, "frames": 2}, motion=dict(mix["motion"], trans_speed_m_per_s=0.3))
    (new / "traffic" / "hover_fast.json").write_text(json.dumps(mix))
    shutil.copy(new / "checks" / "tum1.xyz.json", new / "checks" / "tiny_cam.hover_fast.json")
    (new / "metrics" / "frames_traced.py").write_text(
        '"""fixture: the traced frames."""\n\n\ndef read(rec):\n    return float(sum(f["prof"] for f in rec.frames))\n')
    bench["configs"].append({"name": "tiny_cam", "source": "fixture", "file": "portbench/configs/tiny_cam.json",
                             "reduced": ["width"], "why": "fixture"})
    bench["workloads"].append({"name": "tiny_cam.hover_fast", "config": "tiny_cam", "traffic": "hover_fast",
                               "chips": 1, "why": "fixture"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "system", "moves": "frames_per_s",
                               "workloads": ["tiny_cam.hover_fast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for f in ("bench.py", "harness.py", "check.py", "run.py", "trace.py", "traffic.py", "scene.py"):
        assert (new / f).read_bytes() == (PKG / f).read_bytes()
    code = (
        "import sys, time, json, torch; sys.path.insert(0, '.'); "
        "from portbench.bench import load_cell; from portbench.harness import run_cell; "
        "from pathlib import Path; torch.set_num_threads(4); "
        "cell = load_cell(Path('.'), 'tiny_cam.hover_fast'); "
        "r, rows = run_cell(cell, 5, 8.0, True, torch.device('cpu'), time.time()); "
        "print(json.dumps(r['metrics']))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=900,
                         env={**__import__("os").environ, "PYTHONPATH": f"{tmp_path}:{ROOT}"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the new metric is read in its cell; the others list the cells they read
    assert got == {"frames_traced": {"value": 2.0, "unit": "frames"}}


def test_benchmark_json_keeps_its_schema():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    assert 1 <= bench["run_seconds"] <= 51 and bench["paths"] == ["portbench"]
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert name.match(w["name"]) and w["config"] in configs and len(w["why"]) <= 200
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file() and (PKG / "checks" / f"{w['name']}.json").is_file()
    reported = {}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} and unit.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        for w in m.get("workloads", cells):
            reported.setdefault(w, set()).add(m["name"])
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"} and name.match(m["name"])
        assert (PKG / "metrics" / f"{m['name']}.py").is_file() and unit.match(m["unit"])
        assert all(m["moves"] in reported[w] for w in m["workloads"])
    for w in cells:
        assert "setup_s" in reported[w] and len(reported[w]) >= 2
        assert any(w in m["workloads"] for m in bench["per_layer"])
