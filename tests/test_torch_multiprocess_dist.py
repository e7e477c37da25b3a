"""Two-process distributed BA over ``torch.distributed`` with gloo on the
CPU: the port's analogue of tests/test_multiprocess_dist.py. Two processes
of ``python -m orbslam_in_practice_tpu_torch.parallel.dist_ba_worker``, 4
landmark shards each, join a process group on a free localhost port
(``parallel/mesh.py::initialize_multihost``) and solve the worker's
problem with all-reduced sums; rank 0's poses agree with the same 8 shards
in one process within 1e-5, its gathered landmarks within 1e-4. Each
worker has 120 s."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from orbslam_in_practice_tpu_torch.parallel.dist_ba_worker import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_ba(tmp_path):
    out = tmp_path / "rank0.npz"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "orbslam_in_practice_tpu_torch.parallel.dist_ba_worker", str(pid), "2", str(port),
             str(out), "--device", "cpu", "--shards-per-rank", "4"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outputs = []
    for p in procs:
        try:
            outputs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"worker timed out:\n{p.communicate()[0][-4000:]}")
    for pid, (p, stdout) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0 and f"worker {pid}: ok" in stdout, f"worker {pid} failed:\n{stdout[-4000:]}"
    data = np.load(out)
    poses, points = run(8, "cpu", 10)
    assert np.abs(data["poses"] - poses).max() < 1e-5
    assert np.abs(data["points"] - points).max() < 1e-4
