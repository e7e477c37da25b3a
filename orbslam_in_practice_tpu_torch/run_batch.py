"""Batch SLAM over several sequences, each map refined by distributed global BA.

    python -m orbslam_in_practice_tpu_torch.run_batch --synthetic 3 --mesh 8 [--device cuda]
    python -m orbslam_in_practice_tpu_torch.run_batch --euroc /data/MH_01 /data/MH_02 --config configs/EuRoC.yaml --mesh 8

The port of the JAX package's ``run_batch.py``: every sequence runs through
``SlamSystem`` on the device, then ``distributed_global_ba`` over ``--mesh``
landmark shards (held by this one process; 0 turns it off), with the
keyframe-only ATE before and after where there is ground truth. Writes
each sequence's TUM trajectory and map checkpoint under ``--out-dir`` and
prints one JSON object. The default device is ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from orbslam_in_practice_tpu_torch.config import SlamConfig, load_config
from orbslam_in_practice_tpu_torch.io.evaluation import ate_rmse


def kf_only_ate(smap, gt_positions, gt_ids=None) -> float:
    """ATE over the keyframe poses alone, the quantity global BA optimises
    (a non-keyframe frame keeps the relative pose it was tracked with)."""
    kfp, valid, fids = smap.hview("kf_pose"), smap.kf_valid_host(), smap.kf_frame_id
    est = [(int(fids[s]), 0.0, kfp[s]) for s in range(len(kfp)) if valid[s] and fids[s] >= 0]
    return ate_rmse(est, gt_positions, gt_ids)[0]


def run_sequence(cfg, frames, gt_positions, gt_ids, mesh, out_prefix: str, device) -> dict:
    """Track ``frames`` ((timestamp, image) pairs), then run distributed
    global BA on the map (when ``mesh`` is set and the map has >= 3
    keyframe slots); save the trajectory and the map under ``out_prefix``."""
    from orbslam_in_practice_tpu_torch.parallel.dist_ba import distributed_global_ba, map_problem, problem_cost
    from orbslam_in_practice_tpu_torch.system import SlamSystem

    system = SlamSystem(cfg, device=device)
    sync = torch.cuda.synchronize if system.tracker.device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    n = 0
    with torch.no_grad():
        for ts, img in frames:
            system.track_monocular(img, ts)
            n += 1
        system.wait_idle()
        sync()
    result = {"frames": n, "fps": n / (time.perf_counter() - t0), **system.map.stats()}
    if gt_positions is not None:
        result["ate_rmse_pre_gba"] = ate_rmse(system.get_trajectory(), gt_positions, gt_ids)[0]
        result["ate_kf_pre_gba"] = kf_only_ate(system.map, gt_positions, gt_ids)
    if mesh is not None and system.map.n_kf >= 3:
        K, inv_s2 = cfg.cam.K(), system.tracker.inv_level_sigma2.cpu().numpy()
        cost_before = problem_cost(map_problem(system.map, K, inv_s2, mesh.n_shards)[0], mesh)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            nc, nl, no = distributed_global_ba(system.map, K, inv_s2, mesh, iterations=10)
        sync()
        seconds = time.perf_counter() - t0
        result["gba"] = {
            "cams": nc, "points": nl, "obs": no, "seconds": seconds, "shards": mesh.n_shards,
            "cost_before": cost_before,
            "cost_after": problem_cost(map_problem(system.map, K, inv_s2, mesh.n_shards)[0], mesh),
        }
        if gt_positions is not None:
            result["ate_rmse_post_gba"] = ate_rmse(system.get_trajectory(), gt_positions, gt_ids)[0]
            result["ate_kf_post_gba"] = kf_only_ate(system.map, gt_positions, gt_ids)
    system.save_trajectory_tum(f"{out_prefix}_traj.txt")
    system.save_map(f"{out_prefix}_map.npz")
    system.shutdown()
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--synthetic", type=int, default=0, help="N rendered sequences")
    ap.add_argument("--euroc", nargs="*", default=[], help="EuRoC sequence dirs")
    ap.add_argument("--tum", nargs="*", default=[], help="TUM sequence dirs")
    ap.add_argument("--config", default=None, help="ORB-SLAM style YAML settings of the dataset sequences")
    ap.add_argument("--frames", type=int, default=40, help="frames of each synthetic sequence")
    ap.add_argument("--mesh", type=int, default=0, help="landmark shards of the distributed global BA (0 = off)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=".", help="where trajectories and maps go")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("run_batch: no CUDA device (pass --device cpu to run on the CPU)")

    from orbslam_in_practice_tpu_torch.io import datasets
    from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam_in_practice_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(args.mesh, device) if args.mesh else None
    os.makedirs(args.out_dir, exist_ok=True)
    out = lambda name: os.path.join(args.out_dir, name)  # noqa: E731
    results = {}
    for i in range(args.synthetic):
        seq = SyntheticSequence(n_frames=args.frames, seed=10 + i)
        frames = ((j * 0.1, seq.render(j)) for j in range(seq.n_frames))
        results[f"synthetic_{i}"] = run_sequence(
            SlamConfig(n_features=800, n_levels=4), frames, seq.gt_centers(), None, mesh, out(f"batch_syn{i}"), device
        )
    for loader, paths in ((datasets.load_euroc, args.euroc), (datasets.load_tum, args.tum)):
        for path in paths:
            ds = loader(path)
            cfg = load_config(args.config) if args.config else SlamConfig()
            ids, pos = ds.gt_positions_for_frames()
            results[path] = run_sequence(cfg, ds.frames(), pos, ids, mesh, out(os.path.basename(path.rstrip("/"))),
                                         device)
    print(json.dumps(results, indent=2, default=str))
    return results


if __name__ == "__main__":
    main()
