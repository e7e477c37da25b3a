"""The front end's layers, each against the bound of its work.

    python -m orbslam_in_practice_tpu_torch.bench_frontend [--device cuda|cpu] [--reps R] [--trials 4]

The counterpart of the repository's ``tools/bench_frontend.py``, at its
shapes and on its inputs:

- ``ORBExtractor`` (800 features, 4 levels) on frame 0 of
  ``SyntheticSequence(n_frames=4, n_points=600, seed=1)``; each rep adds
  1e-12 of the last extraction's response sum to the image;
- ``hamming_matrix`` at 800x800 and 800x4096 over 8 stacked ±1 query
  matrices, rep i reading query i mod 8 and adding its distances' sum to a
  float32 accumulator;
- ``search_by_projection``: 2048 landmarks (the frame's features
  back-projected into the scene, repeated, with random descriptors) against
  the 800 features at radius 7; each rep adds 1e-12 of the last
  projection's sum to the points.

So each rep depends on the one before it. The random draws come from one
``default_rng(0)`` in the tool's order. Each shape prints a line (see
``bench_kernels.layer_row``): host ms a rep, kernel ms, launches, busy share
and the bound of the work counted here (``*_work``: each input byte read
once, each output written once; twice the float instructions as flops, an
FMA being one instruction). Reps default to the tool's (10, 50, 20).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.bench_kernels import (
    bench_device, card, chain, fast_work, layer_row, nbytes, patch_work,
)
from orbslam_in_practice_tpu_torch.frontend.matcher import search_by_projection
from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor
from orbslam_in_practice_tpu_torch.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch.ops.hamming import hamming_matrix
from orbslam_in_practice_tpu_torch.ops.image import build_pyramid

N_FEATURES, N_LEVELS = 800, 4
HAMMING_SHAPES = ((800, 800), (800, 4096))
HAMMING_STACK = 8
SBP_POINTS, SBP_RADIUS = 2048, 7.0
REPS = {"extractor": 10, "hamming": 50, "search_by_projection": 20}
TRIALS = 4
# search_by_projection's float instructions: a point's transform (9 FMAs),
# projection (4), extent test (5) and distance (4); a pair's ±1 dot product
# (256 FMAs), its conversion to a distance (2), the window test (4), octave
# test (2), select (1) and row minimum (1); a feature's share of the frame's
# extents (4)
SBP_OPS_POINT, SBP_OPS_PAIR, SBP_OPS_FEATURE = 22, 266, 4


def hamming_work(n: int, m: int) -> tuple:
    """(flops, bytes) of ``hamming_matrix`` on (n, 256) and (m, 256) int8
    rows: the dot products' n m 256 FMAs; the rows read, the int32
    distances written."""
    return 2.0 * n * m * 256, (n + m) * 256 + 4 * n * m


def search_work(n_points: int, n_features: int, inputs, outputs) -> tuple:
    """(flops, bytes) of ``search_by_projection`` of ``n_points`` landmarks
    into ``n_features`` features: ``inputs`` (the tensors it reads) read
    once, ``outputs`` written once."""
    ops = n_points * SBP_OPS_POINT + n_points * n_features * SBP_OPS_PAIR + n_features * SBP_OPS_FEATURE
    return 2.0 * ops, nbytes(inputs) + nbytes(outputs)


def extractor_work(extractor: ORBExtractor, image: torch.Tensor, frame) -> tuple:
    """(flops, bytes) of one extraction of ``image`` giving ``frame``: the
    pyramid's two-tap rows and columns (2 instructions a tap pair), kernel
    A's and B's instructions (``fast_work``, ``patch_work``); the image read
    once and the frame written once. Keypoint selection is not counted."""
    levels = build_pyramid(image, extractor.n_levels, extractor.scale_factor)
    h0, w0 = image.shape
    ops = sum(2 * h * (w0 + w) for h, w in (lvl.shape for lvl in levels[1:]))
    kept = [levels[lvl] for lvl in extractor.levels]
    ops += fast_work(kept)[0] + patch_work(kept, frame.n_features)[0]
    return 2.0 * ops, nbytes(image) + nbytes(frame)


def run(device, reps: int | None = None, trials: int = TRIALS) -> list:
    """The tool's three layers on ``device``, a row each (``layer_row``);
    ``reps`` R for every layer, else the tool's."""
    rng = np.random.default_rng(0)
    seq = SyntheticSequence(n_frames=4, n_points=600, seed=1)
    img = torch.from_numpy(seq.render(0)).to(device)
    ext = ORBExtractor(N_FEATURES, n_levels=N_LEVELS).to(device)
    rows = []
    with torch.no_grad():
        def ext_step(carry, i):
            im, acc = carry
            fr = ext(im)
            return im + torch.sum(fr.response) * 1e-12, acc + torch.sum(fr.xy)

        frame = ext(img)
        rows.append(layer_row(
            f"extractor 640x480 / {N_FEATURES} feat / {N_LEVELS} lvl",
            chain(ext_step, (img, torch.zeros((), device=device))), reps or REPS["extractor"], trials,
            *extractor_work(ext, img, frame), device,
        ))

        for n, m in HAMMING_SHAPES:
            a_stack = torch.from_numpy((rng.integers(0, 2, (HAMMING_STACK, n, 256)) * 2 - 1).astype(np.int8)).to(device)
            b = torch.from_numpy((rng.integers(0, 2, (m, 256)) * 2 - 1).astype(np.int8)).to(device)

            def ham_step(acc, i, a_stack=a_stack, b=b):
                return acc + torch.sum(hamming_matrix(a_stack[i % HAMMING_STACK], b), dtype=torch.float32)

            rows.append(layer_row(f"hamming_matrix {n}x{m}", chain(ham_step, torch.zeros((), device=device)),
                                  reps or REPS["hamming"], trials, *hamming_work(n, m), device))

        xy = frame.xy.cpu().numpy()
        pts_w, valid = seq.backproject(0, xy[:SBP_POINTS] if frame.n_features >= SBP_POINTS else xy)
        pts_w = torch.from_numpy(np.resize(pts_w, (SBP_POINTS, 3)).astype(np.float32)).to(device)
        desc = torch.from_numpy((rng.integers(0, 2, (SBP_POINTS, 256)) * 2 - 1).astype(np.int8)).to(device)
        pts_valid = torch.from_numpy(np.resize(np.asarray(valid), SBP_POINTS)).to(device)
        octave = torch.zeros(SBP_POINTS, dtype=torch.int32, device=device)
        K = torch.from_numpy(np.asarray(seq.K, np.float32)).to(device)
        Tcw = torch.from_numpy(np.asarray(seq.poses[1], np.float32)).to(device)
        sf = torch.from_numpy((ext.scale_factor ** np.arange(ext.n_levels)).astype(np.float32)).to(device)

        def search(pw):
            return search_by_projection(pw, desc, pts_valid, octave, Tcw, frame, K, SBP_RADIUS, sf)

        def sbp_step(carry, i):
            pw, acc = carry
            m_, proj, _ = search(pw)
            return pw + torch.sum(proj) * 1e-12, acc + torch.sum(m_)

        reads = (pts_w, desc, pts_valid, octave, Tcw, frame.xy, frame.valid, frame.octave, frame.desc_pm1, K, sf)
        rows.append(layer_row(
            f"search_by_projection {SBP_POINTS} lm x {frame.n_features} feat",
            chain(sbp_step, (pts_w, torch.zeros((), dtype=torch.int64, device=device))),
            reps or REPS["search_by_projection"], trials,
            *search_work(SBP_POINTS, frame.n_features, reads, search(pts_w)), device,
        ))
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--reps", type=int, help="R for every layer (default: the tool's)")
    parser.add_argument("--trials", type=int, default=TRIALS)
    opts = parser.parse_args(argv)
    device = bench_device(opts.device)
    print(f"device: {card() if device.type == 'cuda' else 'cpu'}; torch {torch.__version__}")
    run(device, opts.reps, opts.trials)


if __name__ == "__main__":
    main()
