"""The port's measuring entry points (``bench``, ``bench_frontend``,
``bench_ba``, ``bench_pose_graph``) on the CPU, against the JAX package's
``bench.py`` and ``tools/`` where they share inputs.

Tolerances: the bench's chain is held per frame to twice the JAX package's
camera-centre error on the un-noised frames (``chip_smoke.py``'s bound);
``make_problem``'s arrays and the pose graph's edges, weights and gauge are
exact; the pose graph's float32 poses within 1e-6 (the packages' ``exp_so3``
may differ by an ulp); ``optimize_pose_graph`` within 1e-3 and
``bundle_adjustment`` within ``test_torch_ba.py``'s bounds (poses 1e-3,
points 1e-3 of their depth, chi2 1e-2 or 1%); work counts exact.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu.frontend.orb import ORBExtractor as JaxExtractor
from orbslam_in_practice_tpu.geometry import se3 as jse3
from orbslam_in_practice_tpu.optim import ba as jba
from orbslam_in_practice_tpu.optim import pose_graph as jpg
from orbslam_in_practice_tpu_torch import bench, bench_ba, bench_frontend, bench_pose_graph
from orbslam_in_practice_tpu_torch.bench_kernels import layer_row, nbytes, slope_ms
from orbslam_in_practice_tpu_torch.bench_state import bench_config, build_bench_state
from orbslam_in_practice_tpu_torch.optim.ba import bundle_adjustment
from orbslam_in_practice_tpu_torch.optim import pose_graph as tpg
from orbslam_in_practice_tpu_torch.optim.pose_graph import ITERATIONS, optimize_pose_graph

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)
CPU = torch.device("cpu")
ENTRY_POINTS = ("bench", "bench_frontend", "bench_ba", "bench_pose_graph")


def _entry(module: str, *args, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", f"orbslam_in_practice_tpu_torch.{module}", *args],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "2", **(env or {})},
    )


@pytest.fixture(scope="module")
def bench_scene():
    """The bench step on the CPU's plain path, its arguments, its noised
    frame batches and the scene."""
    step, args, images, seq = build_bench_state(bench_config(), n_images=bench.REPS, device=CPU, use_kernels=False)
    return step, args, images, bench.noised_batches(images, CPU), seq


def _centre(T: np.ndarray) -> np.ndarray:
    return -(T[:3, :3].T @ T[:3, 3])


@pytest.mark.parametrize("batch", range(bench.N_BATCHES))
def test_noised_chain_tracks_every_frame(bench_scene, batch):
    """Each noised batch, chained from the bench's pose and velocity, tracks
    all its frames, each within twice the JAX package's camera-centre error
    of the un-noised frame."""
    step, args, _, batches, seq = bench_scene
    _, packed, V, T, *tables = args
    with torch.no_grad():
        for i, image in enumerate(batches[batch]):
            _, T, _, V, _, ok, _ = step(image, packed, V, T, *tables)
            err = float(np.linalg.norm(_centre(T.numpy()) - _centre(seq.poses[1 + i])))
            assert bool(ok), f"frame {1 + i} not tracked"
            assert err < 2.0 * chip_smoke.REFERENCE_CENTRE_ERR[i], f"frame {1 + i}: centre error {err}"
        if batch == 0:  # the bench's call chains the same frames the same way
            T_call, oks = bench.chained_call(step, args)(batches[batch])
            assert torch.equal(T_call, T) and oks.dtype == torch.bool and bool(oks.all())


def test_noised_batches_are_fixed_point_gray_levels(bench_scene):
    """The batches are the frames in 8.8 fixed point plus [0, 1) levels of
    noise, each batch its own; root ``bench.py`` passes float32 renders to
    the step, which divides them by 256: the JAX extractor then finds no
    feature, where the port's frames keep the bench's 512."""
    _, _, images, batches, seq = bench_scene
    assert len(batches) == bench.N_BATCHES and all(b.dtype == torch.uint16 for b in batches)
    for b in batches:
        d = b.numpy().astype(np.float32) / 256.0 - images.astype(np.float32) / 256.0
        assert d.min() >= -1.0 / 256.0 and d.max() < 1.0 + 1.0 / 256.0 and 0.45 < d.mean() < 0.55
    assert not torch.equal(batches[0], batches[1])
    jex = JaxExtractor(512, 1.2, 4, 20.0, 7.0, use_pallas=False)
    render = seq.render(1).astype(np.float32)
    assert int(jex(jnp.asarray(render * (1.0 / 256.0))).valid.sum()) == 0
    decoded = batches[0][0].numpy().astype(np.float32) * (1.0 / 256.0)
    assert int(jex(jnp.asarray(decoded)).valid.sum()) == 512


def test_bench_prints_root_bench_keys_on_cpu():
    res = _entry("bench", "--device", "cpu", "--calls", "1", "--trials", "1", env={"BENCH_SKIP_CPU_BASELINE": "1"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    root_keys = {"metric", "value", "unit", "vs_baseline", "baseline_fps", "baseline_source"}
    assert root_keys | {"median", "trials_fps", "tracked", "tracked_min", "gpu", "power_limit_w"} == set(line)
    assert line["metric"] == "tracked_frames_per_s" and line["unit"] == "frames/s"
    assert line["value"] > 0 and line["trials_fps"] == [line["value"]] == [line["median"]]
    assert line["tracked"] == line["tracked_min"] == bench.REPS
    assert line["baseline_source"] == "skipped" and line["vs_baseline"] is None and line["baseline_fps"] is None
    assert line["gpu"] is None and line["power_limit_w"] is None


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_refuses_a_missing_card(module):
    """``--device cuda`` (the default) without a card exits non-zero before
    measuring anything; it never measures the CPU instead."""
    for args in (("--device", "cuda"), ()):
        res = _entry(module, *args, env={"CUDA_VISIBLE_DEVICES": ""}, timeout=120)
        assert res.returncode != 0 and res.stdout == ""
        assert "no CUDA device" in res.stderr


def test_result_line_reads_the_card_and_the_baseline():
    res = {"trials_fps": [3.0, 4.0, 3.5], "tracked": [10, 9, 10]}
    line = bench.result_line(res, {"trials_fps": [1.0, 2.0]}, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert (line["value"], line["median"], line["baseline_fps"], line["vs_baseline"]) == (4.0, 3.5, 2.0, 2.0)
    assert (line["tracked"], line["tracked_min"], line["baseline_source"]) == (10, 9, "measured_in_run")
    assert (line["gpu"], line["power_limit_w"]) == ("NVIDIA H100 80GB HBM3", 700.0)
    assert bench.result_line(res, None, "NVIDIA H100 80GB HBM3, [N/A]")["power_limit_w"] is None


def _load_tool(name: str):
    """tools/<name>.py as a module. It sets the compilation-cache settings
    of ``jax.config`` when imported: both are restored."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        spec = importlib.util.spec_from_file_location(f"_tool_{name}", ROOT / "tools" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return module


@pytest.fixture(scope="module")
def jax_bench_ba():
    return _load_tool("bench_ba")


@pytest.mark.parametrize("shape", bench_ba.SHAPES, ids=lambda s: "W{}-L{}-F{}".format(*s))
def test_make_problem_equals_the_tool(jax_bench_ba, shape):
    want = jax_bench_ba.make_problem(*shape)
    got = bench_ba.make_arrays(*shape)
    assert set(got) == set(want._fields)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        assert got[name].dtype == w.dtype and np.array_equal(got[name], w), name
    prob = bench_ba.make_problem(*shape, device=CPU)
    assert prob.obs_cam.dtype == prob.point_obs.dtype == torch.int64
    assert np.array_equal(prob.point_obs.numpy(), np.asarray(want.point_obs))


def test_bundle_adjustment_on_the_bench_problem_matches_jax():
    """The W = 5 window, bench_ba's 10 iterations, both packages."""
    shape = bench_ba.SHAPES[0]
    fields = bench_ba.make_arrays(*shape)
    want = jba.bundle_adjustment(jba.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}),
                                 iterations=bench_ba.ITERATIONS)
    P_j, X_j, c_j = (np.asarray(w) for w in want)
    P_t, X_t, c_t = (g.numpy() for g in bundle_adjustment(bench_ba.make_problem(*shape, device=CPU),
                                                         iterations=bench_ba.ITERATIONS))
    assert np.abs(P_t - P_j).max() < 1e-3
    assert np.all(np.abs(X_t - X_j) < 1e-3 * fields["points"][:, 2:3])
    fin = np.isfinite(c_j)
    assert np.array_equal(np.isfinite(c_t), fin)
    assert np.all(np.abs(c_t - c_j)[fin] < np.maximum(1e-2, 1e-2 * c_j[fin]))
    assert np.median(c_t[fin]) < 2.0


def _tool_graph(k: int, rng):
    """tools/bench_pose_graph.py's graph recipe, with the JAX package's
    ``exp_so3`` (the tool builds it inside ``main``)."""
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
    poses = []
    for a in ang:
        c = np.array([5 * np.sin(a), 0, 5 - 5 * np.cos(a)], np.float32)
        R_wc = np.asarray(jse3.exp_so3(jnp.asarray([0.0, a, 0.0], dtype=jnp.float32)))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ c
        poses.append(T)
    S = np.stack(poses)
    S_inv = np.linalg.inv(S)
    ei, ej = list(range(k - 1)), list(range(1, k))
    for i in range(0, k - 3, 3):
        ei.append(i)
        ej.append(i + 3)
    ei.append(k - 1)
    ej.append(0)
    ei, ej = np.asarray(ei, np.int32), np.asarray(ej, np.int32)
    meas = (S[ej] @ S_inv[ei]).astype(np.float32)
    Sp = S.copy()
    Sp[:, :3, 3] += rng.normal(0, 0.05, (k, 3)).astype(np.float32)
    w = np.ones(len(ei), np.float32)
    w[-1] = 5.0
    fixed = np.zeros(k, bool)
    fixed[0] = True
    return Sp, ei, ej, meas, w, fixed


def test_pose_graph_equals_the_tool_and_optimizes_as_jax():
    k, got = next(bench_pose_graph.circle_graphs())
    want = _tool_graph(k, np.random.default_rng(0))
    assert k == 48
    for i in (1, 2, 4, 5):
        assert got[i].dtype == want[i].dtype and np.array_equal(got[i], want[i])
    for i in (0, 3):
        assert got[i].dtype == np.float32 and np.abs(got[i] - want[i]).max() < 1e-6
    # the sizes after the first draw from the same generator, as in the tool
    rng = np.random.default_rng(0)
    _tool_graph(48, rng)
    later = dict(bench_pose_graph.circle_graphs())
    assert np.abs(later[89][0] - _tool_graph(89, rng)[0]).max() < 1e-6
    out_j = np.asarray(jpg.optimize_pose_graph(*map(jnp.asarray, got), iterations=ITERATIONS))
    out_t = optimize_pose_graph(*(torch.from_numpy(a) for a in got)).numpy()
    assert np.abs(out_t - out_j).max() < 1e-3
    assert np.array_equal(out_t[0], got[0][0])
    # the loop edge's residual falls
    zero = torch.zeros((1, 7))

    def loop_residual(S):
        i, j = got[1][-1], got[2][-1]
        return float(tpg.edge_residual(zero, zero, torch.from_numpy(S[None, i]), torch.from_numpy(S[None, j]),
                                       torch.from_numpy(got[3][-1:])).norm())

    assert loop_residual(out_t) < 0.5 * loop_residual(got[0])


def test_layer_benches_run_on_the_cpu(capsys):
    """Each layer bench's ``run`` gives a row per shape on the CPU with its
    host ms and bound, and leaves the device's columns unmeasured."""
    rows = (bench_frontend.run(CPU, reps=1, trials=1) + bench_ba.run(CPU, 1, 1, shapes=bench_ba.SHAPES[:1])
            + bench_pose_graph.run(CPU, 1, 1, sizes=(48,)))
    out = capsys.readouterr().out
    assert len(rows) == 6 and len(out.strip().splitlines()) == 6
    for row in rows:
        assert row["kernel_ms"] is None and row["launches"] is None and row["busy"] is None
        assert len(row["host_ms_trials"]) == 1 and row["bound_ms"] > 0
        assert row["bound_by"] in ("operations", "bytes") and row["label"] in out
    assert "not measured" in out
    assert [r["unit"] for r in rows[-2:]] == ["LM iteration", "call"]


def test_slope_cancels_the_fixed_cost():
    """``slope_ms`` is (t(2R) - t(R)) / R: a rep that costs nothing reads
    about 0 ms however long a run's fixed part takes."""
    calls = []
    slopes = slope_ms(lambda: calls.append(1), reps=5, trials=3, device=CPU)
    assert len(slopes) == 3 and len(calls) == 1 + 3 * 15
    assert all(abs(s) < 1.0 for s in slopes)


@pytest.mark.parametrize("n,m", bench_frontend.HAMMING_SHAPES)
def test_hamming_work_is_exact(n, m):
    flops, nbytes_ = bench_frontend.hamming_work(n, m)
    assert flops == 2 * n * m * 256
    a = torch.ones((n, 256), dtype=torch.int8)
    b = torch.ones((m, 256), dtype=torch.int8)
    out = torch.zeros((n, m), dtype=torch.int32)
    assert nbytes_ == nbytes(a, b, out) == (n + m) * 256 + 4 * n * m


def test_search_work_counts_pairs_points_and_bytes():
    inputs = (torch.zeros((7, 3)), torch.zeros((7, 256), dtype=torch.int8))
    outputs = (torch.zeros(7, dtype=torch.int32), torch.zeros((7, 2)))
    flops, nbytes_ = bench_frontend.search_work(7, 5, inputs, outputs)
    ops = 7 * bench_frontend.SBP_OPS_POINT + 35 * bench_frontend.SBP_OPS_PAIR + 5 * bench_frontend.SBP_OPS_FEATURE
    assert flops == 2 * ops
    assert nbytes_ == 7 * 12 + 7 * 256 + 7 * 4 + 7 * 8


def test_lm_work_counts_schur_blocks_and_bytes():
    shape = bench_ba.SHAPES[0]
    fields = bench_ba.make_arrays(*shape)
    prob = bench_ba.make_problem(*shape, device=CPU)
    per_point = np.bincount(fields["obs_point"], minlength=shape[1])
    assert np.array_equal((prob.point_obs >= 0).sum(1).numpy(), np.minimum(per_point, 8))
    n_cam, n_obs, n_pts = shape[0], shape[0] * shape[2], shape[1]
    ops = (n_obs * bench_ba.BA_OPS_OBS + n_pts * bench_ba.BA_OPS_POINT
           + int((np.minimum(per_point, 8) ** 2).sum()) * bench_ba.BA_OPS_SCHUR_BLOCK + (6 * n_cam) ** 3 / 3
           + (6 * n_cam) ** 2)
    flops, nbytes_ = bench_ba.lm_work(prob)
    assert flops == 2 * ops
    state = n_cam * 64 + n_pts * 12 + 4
    problem = (n_cam * 64 + n_pts * 12 + n_obs * (8 + 8 + 8 + 4 + 1) + n_pts * 8 * 8 + n_cam + 36)
    assert nbytes_ == 2 * state + problem + 4 * n_obs


def test_graph_work_counts_the_solve_and_bytes():
    k, graph = next(bench_pose_graph.circle_graphs())
    args = tuple(torch.from_numpy(a) for a in graph)
    e = k + 15
    flops, nbytes_ = bench_pose_graph.graph_work(args)
    m = 7 * k
    assert len(graph[1]) == e
    assert flops == 2 * ITERATIONS * (e * bench_pose_graph.PG_OPS_EDGE + k * bench_pose_graph.PG_OPS_VERTEX
                                      + m**3 / 3 + m**2)
    assert nbytes_ == 2 * k * 64 + e * (4 + 4 + 64 + 4) + k


def test_layer_row_bound_is_the_larger_time():
    row = layer_row("t", lambda: None, 1, 1, 67e12 * 1e-3, 3.35e12 * 2e-3, CPU)
    assert abs(row["bound_ms"] - 2.0) < 1e-9 and row["bound_by"] == "bytes"
    row = layer_row("t", lambda: None, 1, 1, 67e12 * 3e-3, 3.35e12 * 2e-3, CPU)
    assert abs(row["bound_ms"] - 3.0) < 1e-9 and row["bound_by"] == "operations"
