"""One rank of a multi-process distributed-BA run.

    python -m orbslam_in_practice_tpu_torch.parallel.dist_ba_worker PID NPROCS PORT OUT.npz \
        [--device cuda] [--shards-per-rank 4] [--iterations 10]

Each process joins the process group at localhost:PORT (NCCL on ``cuda``,
the default: rank PID drives device PID; gloo on ``cpu``), builds the same
deterministic BA problem (``make_problem``: 4 cameras, 64 landmarks, the
first two cameras fixed, the rest perturbed), partitions it into
``NPROCS * shards-per-rank`` landmark shards and runs the all-reduced LM
loop on its own shards. Rank 0 writes the poses and the gathered landmarks
to OUT.npz, to be held against a single-process run of the same shards.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def make_problem(seed: int = 7, n_cams: int = 4, n_pts: int = 64) -> dict:
    """A deterministic BA problem, every camera observing every landmark:
    landmarks at depth 5-12, cameras 0.25 apart with small rotations, then
    cameras 2.. and the landmarks perturbed (the draws of
    tests/test_dist_ba.py and tools/dist_ba_worker.py, in their order: seed
    0 with 6 cameras and 256 landmarks is the former's problem, the
    defaults the latter's). Returns a dict: the perturbed start ``poses0``,
    ``points0``, the observations ``obs_cam``, ``obs_point``, ``obs_uv``,
    ``fixed`` (cameras 0 and 1), ``K``, and the truth ``poses``,
    ``points``."""
    from orbslam_in_practice_tpu_torch.geometry.se3 import exp_se3, exp_so3

    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
    pts = np.stack(
        [rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(5, 12, n_pts)], axis=-1
    ).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    for c in range(n_cams):
        poses[c, :3, :3] = exp_so3(torch.from_numpy((rng.normal(size=3) * 0.02).astype(np.float32))).numpy()
        poses[c, :3, 3] = [0.25 * c, 0.01 * c, 0.0]
    pc = np.einsum("cij,pj->cpi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    uv = (pc[..., :2] / pc[..., 2:3]) * np.diag(K)[:2] + K[:2, 2]
    poses0 = poses.copy()
    xi = torch.from_numpy((rng.normal(size=(n_cams - 2, 6)) * 0.03).astype(np.float32))
    poses0[2:] = exp_se3(xi).numpy() @ poses0[2:]
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    return dict(
        poses0=poses0, points0=pts + rng.normal(size=pts.shape).astype(np.float32) * 0.08,
        obs_cam=np.repeat(np.arange(n_cams), n_pts).astype(np.int32),
        obs_point=np.tile(np.arange(n_pts), n_cams).astype(np.int32),
        obs_uv=uv.reshape(-1, 2).astype(np.float32), fixed=fixed, K=K, poses=poses, points=pts,
    )


def run(n_shards: int, mesh_device, iterations: int, **problem) -> tuple:
    """``make_problem(**problem)`` partitioned into ``n_shards`` and solved
    over the current process group (or alone): (poses, points) as numpy."""
    from orbslam_in_practice_tpu_torch.parallel.dist_ba import dist_bundle_adjustment, partition_ba_problem
    from orbslam_in_practice_tpu_torch.parallel.mesh import make_mesh

    p = make_problem(**problem)
    prob = partition_ba_problem(
        p["poses0"], p["points0"], p["obs_cam"], p["obs_point"], p["obs_uv"], np.ones(len(p["obs_cam"]), np.float32),
        p["fixed"], p["K"], n_shards=n_shards,
    )
    with torch.no_grad():
        poses, points = dist_bundle_adjustment(prob, make_mesh(n_shards, mesh_device), iterations=iterations)
    return poses.cpu().numpy(), points.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda", help="cuda (default, NCCL) or cpu (gloo)")
    ap.add_argument("--shards-per-rank", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=10)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from orbslam_in_practice_tpu_torch.parallel.mesh import initialize_multihost

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("dist_ba_worker: no CUDA device (pass --device cpu for gloo on the CPU)")
        device = torch.device("cuda", args.pid % torch.cuda.device_count())
        torch.cuda.set_device(device)
    initialize_multihost(f"localhost:{args.port}", args.nprocs, args.pid, "nccl" if device.type == "cuda" else "gloo")
    poses, points = run(args.nprocs * args.shards_per_rank, device, args.iterations)
    if args.pid == 0:
        np.savez(args.out, poses=poses, points=points)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    print(f"worker {args.pid}: ok", flush=True)


if __name__ == "__main__":
    main()
