"""What the benchmark loads: no JAX and no JAX package anywhere, and
nothing of the port in the plain reference. Names are compared by their
top-level part (before the first dot), whole: the port's name begins with
the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "orbslam_in_practice_tpu"}
PORT = "orbslam_in_practice_tpu_torch"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")))
def test_no_module_of_the_benchmark_imports_jax(path):
    assert not (_imports(PKG / path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix() for p in (PKG / "reference").rglob("*.py")))
def test_the_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imports(PKG / path)


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_loads_nothing_of_the_port():
    names = _run(
        "import sys; import portbench.reference.extract, portbench.reference.step, portbench.reference.ba; "
        "print(sorted({m.split('.')[0] for m in sys.modules}))"
    )
    assert PORT not in names and not any(f"'{f}'" in names for f in FORBIDDEN)


def test_a_cpu_rehearsal_loads_no_jax():
    line = _run(
        "import time, torch; from portbench.harness import run_cell; from portbench.tests.tiny import tiny_cell; "
        "from portbench.run import forbidden_modules; torch.set_num_threads(4); "
        "r, _ = run_cell(tiny_cell(), 3, 8.0, True, torch.device('cpu'), time.time()); "
        "print(forbidden_modules(), r['attempted'])"
    )
    assert line.startswith("[]"), line
