"""Pose-graph (essential-graph) optimisation at the loop closer's sizes.

    python -m orbslam_in_practice_tpu_torch.bench_pose_graph [--device cuda|cpu] [--reps 2] [--trials 3]

The counterpart of the repository's ``tools/bench_pose_graph.py``: on a
circle of K keyframes (``circle_graphs``), K = SIZES, a chain, an edge from
every third keyframe to the one three on, and one loop edge (K-1 -> 0,
weight 5), measured from the true poses; the vertices' positions perturbed
by 0.05, keyframe 0 fixed. A rep is one ``optimize_pose_graph`` (its 25
Gauss-Newton iterations, the loop closer's call) on that graph. Each size
prints a line (``bench_kernels.layer_row``) whose bound is ``graph_work``'s.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.bench_kernels import bench_device, card, layer_row, nbytes
from orbslam_in_practice_tpu_torch.geometry.se3 import exp_so3
from orbslam_in_practice_tpu_torch.optim.pose_graph import ITERATIONS, optimize_pose_graph

SIZES = (48, 89, 256)
REPS, TRIALS = 2, 3  # a call takes ~2 s on the card: 22 calls a size
# one Gauss-Newton iteration's float instructions (an FMA is one). An edge:
# its Sim(3) residual before and after the step (2 x 300: three 4x4
# products, an inverse, a logarithm), its two 7x7 Jacobian blocks (686),
# its four 7x7 Hessian blocks J^T W J (1372) and gradient (98). A vertex:
# the update's exponential and product (214). The 7 K unknowns' system: LU
# (n^3 / 3) and the two triangular solves (n^2).
PG_OPS_EDGE, PG_OPS_VERTEX = 2756, 214


def circle_graph(k: int, rng: np.random.Generator) -> tuple:
    """The tool's graph of ``k`` keyframes, its noise drawn from ``rng``:
    (vertices (k, 4, 4), edge_i, edge_j (E,) int32, measurements (E, 4, 4),
    weights (E,), fixed (k,) bool) as numpy arrays."""
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
    poses = []
    for a in ang:
        c = np.array([5 * np.sin(a), 0, 5 - 5 * np.cos(a)], np.float32)
        R_wc = exp_so3(torch.tensor([0.0, a, 0.0], dtype=torch.float32)).numpy()
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ c
        poses.append(T)
    S = np.stack(poses)
    S_inv = np.linalg.inv(S)
    ei = list(range(k - 1))
    ej = list(range(1, k))
    for i in range(0, k - 3, 3):
        ei.append(i)
        ej.append(i + 3)
    ei.append(k - 1)
    ej.append(0)
    ei = np.asarray(ei, np.int32)
    ej = np.asarray(ej, np.int32)
    meas = (S[ej] @ S_inv[ei]).astype(np.float32)
    noise = rng.normal(0, 0.05, (k, 3)).astype(np.float32)
    Sp = S.copy()
    Sp[:, :3, 3] += noise
    w = np.ones(len(ei), np.float32)
    w[-1] = 5.0
    fixed = np.zeros(k, bool)
    fixed[0] = True
    return Sp, ei, ej, meas, w, fixed


def circle_graphs(sizes=SIZES, seed: int = 0):
    """(k, ``circle_graph``) for each of ``sizes`` in order, all drawn from
    one ``default_rng(seed)`` as the tool draws them."""
    rng = np.random.default_rng(seed)
    for k in sizes:
        yield k, circle_graph(k, rng)


def graph_work(args) -> tuple:
    """(flops, bytes) of one ``optimize_pose_graph`` on ``args`` (as
    tensors): ITERATIONS iterations of PG_OPS_* over its edges and vertices
    and its 7 K-unknown solve; the arguments read once, the vertices
    written once."""
    n, e = args[0].shape[0], args[1].shape[0]
    m = 7 * n
    ops = ITERATIONS * (e * PG_OPS_EDGE + n * PG_OPS_VERTEX + m**3 / 3 + m**2)
    return 2.0 * ops, nbytes(args) + nbytes(args[0])


def run(device, reps: int = REPS, trials: int = TRIALS, sizes=SIZES) -> list:
    """A row per size (``layer_row``, units of one call)."""
    rows = []
    with torch.no_grad():
        for k, graph in circle_graphs(sizes):
            args = tuple(torch.from_numpy(a).to(device) for a in graph)
            rows.append(layer_row(
                f"pose graph K={k:4d} E={args[1].shape[0]:4d} {ITERATIONS}-iter optimize",
                lambda args=args: optimize_pose_graph(*args), reps, trials, *graph_work(args), device,
                unit="call",
            ))
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--reps", type=int, default=REPS)
    parser.add_argument("--trials", type=int, default=TRIALS)
    opts = parser.parse_args(argv)
    device = bench_device(opts.device)
    print(f"device: {card() if device.type == 'cuda' else 'cpu'}; torch {torch.__version__}")
    run(device, opts.reps, opts.trials)


if __name__ == "__main__":
    main()
