"""Local BA in ms a Levenberg-Marquardt iteration, against its bound.

    python -m orbslam_in_practice_tpu_torch.bench_ba [--device cuda|cpu] [--reps 10] [--trials 4]

The counterpart of the repository's ``tools/bench_ba.py``: a local-BA
window of W keyframes, L landmarks and F observations a keyframe
(``make_problem``: the tool's numpy arrays from the same seed), at W/L/F =
SHAPES. A rep is ``bundle_adjustment(iterations=10)`` whose refined points
seed the next rep. Each shape prints a line (``bench_kernels.layer_row``)
in units of one LM iteration: host ms, kernel ms, launches and busy share
of a rep over 10, and the bound of one ``lm_iteration`` (``lm_work``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.bench_kernels import bench_device, card, chain, layer_row, nbytes
from orbslam_in_practice_tpu_torch.optim.ba import BAProblem, build_point_obs, bundle_adjustment, included_obs_mask

SHAPES = ((5, 600, 300), (10, 1500, 400), (20, 4000, 500))
ITERATIONS = 10  # LM iterations a rep
REPS, TRIALS = 10, 4
# one LM iteration's float instructions (an FMA is one). An observation: its
# residual and depth (15), Jacobians (42), robust weight (6), its camera
# block J^T W J (72) and gradient (12 + 12 for the weighting), its landmark
# block (18), gradient (6) and camera-landmark block W (36), W Hpp^-1 (54)
# and its gradient share (18), the back-substitution (18), the cost before
# and after the step (42). A landmark: its damped 3x3 inverse and update
# (52). A Schur block, per pair of one landmark's observations: T W^T (108).
# The reduced camera system of 6 W unknowns: LU (n^3 / 3) and the two
# triangular solves (n^2).
BA_OPS_OBS, BA_OPS_POINT, BA_OPS_SCHUR_BLOCK = 351, 52, 108


def make_arrays(n_cams=6, n_pts=800, obs_per_cam=400, o_max=8, seed=0) -> dict:
    """The numpy fields of ``tools/bench_ba.py::make_problem``'s BAProblem,
    drawn in its order from ``default_rng(seed)``: cameras 0.08 apart along
    x, points in a 4 x 3 x 5 box, ``obs_per_cam`` distinct points a camera
    with 0.8 px noise, points perturbed by 0.03, camera 0 fixed."""
    rng = np.random.default_rng(seed)
    K = np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1.0]], np.float32)
    pts = np.stack(
        [rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(3, 8, n_pts)],
        axis=-1,
    ).astype(np.float32)
    poses = []
    for c in range(n_cams):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.08 * c, 0.01 * c, 0.0]
        poses.append(T)
    poses = np.stack(poses)
    obs_cam, obs_point, obs_uv = [], [], []
    for c in range(n_cams):
        sel = rng.choice(n_pts, size=obs_per_cam, replace=False)
        pc = pts[sel] @ poses[c][:3, :3].T + poses[c][:3, 3]
        uv = pc[:, :2] / pc[:, 2:3] * np.diag(K)[:2] + K[:2, 2]
        obs_cam += [c] * obs_per_cam
        obs_point += list(sel)
        obs_uv.append(uv + rng.normal(size=uv.shape).astype(np.float32) * 0.8)
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_point = np.asarray(obs_point, np.int32)
    obs_uv = np.concatenate(obs_uv).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    return dict(
        poses=poses,
        points=pts + rng.normal(size=pts.shape).astype(np.float32) * 0.03,
        obs_cam=obs_cam,
        obs_point=obs_point,
        obs_uv=obs_uv,
        obs_inv_sigma2=np.ones(len(obs_cam), np.float32),
        obs_mask=np.ones(len(obs_cam), bool),
        point_obs=build_point_obs(obs_point, n_pts, o_max),
        fixed_cam=fixed,
        K=K,
    )


def make_problem(n_cams=6, n_pts=800, obs_per_cam=400, o_max=8, seed=0, device="cuda") -> BAProblem:
    """``make_arrays`` as a BAProblem on ``device`` (indices int64)."""
    fields = {k: torch.from_numpy(v) for k, v in make_arrays(n_cams, n_pts, obs_per_cam, o_max, seed).items()}
    for k in ("obs_cam", "obs_point", "point_obs"):
        fields[k] = fields[k].long()
    return BAProblem(**{k: v.to(device) for k, v in fields.items()})


def lm_work(prob: BAProblem) -> tuple:
    """(flops, bytes) of one ``lm_iteration`` on ``prob``: BA_OPS_* over its
    observations, landmarks and Schur blocks (the pairs of each landmark's
    observations, counted from ``point_obs``) and the reduced camera
    system's solve; the poses, points, damping, problem and observation
    weights read once, the poses, points and damping written once."""
    n_obs, n_pts, n_cams = prob.obs_cam.shape[0], prob.points.shape[0], prob.poses.shape[0]
    per_point = (prob.point_obs >= 0).sum(dim=1).to(torch.int64)
    blocks = int(torch.sum(per_point * per_point))
    n = 6 * n_cams
    ops = n_obs * BA_OPS_OBS + n_pts * BA_OPS_POINT + blocks * BA_OPS_SCHUR_BLOCK + n**3 / 3 + n**2
    lam = torch.zeros((), dtype=prob.poses.dtype)
    w_obs = included_obs_mask(prob.point_obs, n_obs).to(prob.poses.dtype)
    state = (prob.poses, prob.points, lam)
    return 2.0 * ops, nbytes(state, tuple(prob), w_obs) + nbytes(state)


def run(device, reps: int = REPS, trials: int = TRIALS, shapes=SHAPES) -> list:
    """A row per shape (``layer_row``, units of one LM iteration)."""
    rows = []
    with torch.no_grad():
        for n_cams, n_pts, per_cam in shapes:
            prob = make_problem(n_cams, n_pts, per_cam, device=device)

            def ba_step(carry, i, prob=prob):
                points, acc = carry
                poses, pts, _ = bundle_adjustment(prob._replace(points=points), iterations=ITERATIONS)
                return pts, acc + torch.sum(poses)

            rows.append(layer_row(
                f"local BA W={n_cams:3d} KF, L={n_pts:5d} lm, O={prob.obs_cam.shape[0]:5d} obs",
                chain(ba_step, (prob.points, torch.zeros((), device=device))), reps, trials, *lm_work(prob), device,
                per=ITERATIONS, unit="LM iteration",
            ))
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--reps", type=int, default=REPS, help=f"R: reps of {ITERATIONS} LM iterations")
    parser.add_argument("--trials", type=int, default=TRIALS)
    opts = parser.parse_args(argv)
    device = bench_device(opts.device)
    print(f"device: {card() if device.type == 'cuda' else 'cpu'}; torch {torch.__version__}")
    run(device, opts.reps, opts.trials)


if __name__ == "__main__":
    main()
