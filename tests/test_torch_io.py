"""The port's dataset loaders, native frame loader and utilities against the
JAX package's, on the CPU.

- ``load_tum``, ``load_kitti``, ``load_euroc`` on tests/test_io.py's tiny
  fixtures: timestamps, image paths, ground truth and the associated
  frames equal to the JAX loaders' exactly, decoded frames too;
- the native decoder (built from ``native/frameio.cpp`` into the package's
  build directory) bit-equal to the JAX package's on binary and ASCII PGM
  and on PPM; ``PrefetchQueue`` yields every frame in order, equal to
  ``read_image``; a missing file gives None;
- the viewer writes non-blank PNGs; ``StageTimer`` counts;
- tests/test_e2e_real_data_glue.py's TUM layout end to end through
  ``run_slam --tum`` on the CPU, frames as 8-bit PGM: tracked >= 15 of
  20, >= 10 aligned, ATE < 0.10; its trajectory, map, log and PNG written.
"""

import json
import os

import numpy as np
import pytest
import torch
from test_io import _write_pgm
from test_native_loader import write_pgm, write_ppm

from orbslam_in_practice_tpu.io import datasets as jds
from orbslam_in_practice_tpu.io import native_loader as jnl
from orbslam_in_practice_tpu.io.synthetic import SyntheticSequence
from orbslam_in_practice_tpu_torch import run_slam
from orbslam_in_practice_tpu_torch.io import datasets, native_loader
from orbslam_in_practice_tpu_torch.utils.logging import FrameLog, StageTimer

torch.set_num_threads(2)

N_GLUE = 20  # tests/test_e2e_real_data_glue.py's frames


def _assert_same_sequence(got, want):
    assert np.array_equal(got.timestamps, want.timestamps) and got.image_paths == want.image_paths
    for name in ("gt_timestamps", "gt_positions", "gt_quats_xyzw"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or np.array_equal(a, b), name
    for a, b in zip(got.gt_positions_for_frames(), want.gt_positions_for_frames()):
        assert (a is None and b is None) or np.array_equal(a, b)
    for (ta, ia), (tb, ib) in zip(got.frames(), want.frames()):
        assert ta == tb and ia.dtype == ib.dtype == np.float32 and np.array_equal(ia, ib)


def test_tum_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "rgb").mkdir()
    lines = ["# comment"]
    for i in range(4):
        _write_pgm(str(tmp_path / "rgb" / f"{i}.pgm"), rng.integers(0, 255, (24, 32)).astype(np.uint8))
        lines.append(f"{i + 0.5:.6f} rgb/{i}.pgm")
    (tmp_path / "rgb.txt").write_text("\n".join(lines))
    (tmp_path / "groundtruth.txt").write_text(
        "# ts tx ty tz qx qy qz qw\n" + "\n".join(f"{i + 0.5:.6f} {i * 0.1} 0 0 0 0 0 1" for i in range(4))
    )
    got = datasets.load_tum(str(tmp_path))
    _assert_same_sequence(got, jds.load_tum(str(tmp_path)))
    assert len(got) == 4 and np.allclose(got.gt_positions_for_frames()[1][:, 0], [0.0, 0.1, 0.2, 0.3])


def test_kitti_loader_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    (tmp_path / "image_0").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (16, 48)).astype(np.uint8)).save(tmp_path / "image_0" / f"{i:06d}.png")
    (tmp_path / "times.txt").write_text("\n".join(f"{i * 0.1:.6f}" for i in range(3)))
    rows = []
    for i in range(3):
        T = np.eye(4)[:3]
        T[0, 3] = i * 1.0
        rows.append(" ".join(f"{v:.6e}" for v in T.reshape(-1)))
    (tmp_path / "00.txt").write_text("\n".join(rows))
    got = datasets.load_kitti(str(tmp_path), str(tmp_path / "00.txt"))
    _assert_same_sequence(got, jds.load_kitti(str(tmp_path), str(tmp_path / "00.txt")))
    assert len(got) == 3 and np.allclose(got.gt_positions[:, 0], [0, 1, 2])


def test_euroc_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    cam = tmp_path / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i in range(3):
        name = f"{1000000000 + i * 50000000}.pgm"
        _write_pgm(str(cam / "data" / name), rng.integers(0, 255, (12, 16)).astype(np.uint8))
        rows.append(f"{1000000000 + i * 50000000},{name}")
    (cam / "data.csv").write_text("\n".join(rows))
    gt = tmp_path / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    (gt / "data.csv").write_text(
        "\n".join(["#ts,px,py,pz,qw,qx,qy,qz"] + [f"{1000000000 + i * 50000000},{i * 0.2},0,0,1,0,0,0" for i in range(3)])
    )
    got = datasets.load_euroc(str(tmp_path))
    _assert_same_sequence(got, jds.load_euroc(str(tmp_path)))
    assert np.allclose(got.gt_positions_for_frames()[1][:, 0], [0.0, 0.2, 0.4])


@pytest.fixture(scope="module")
def native_ok():
    if not native_loader.available():
        pytest.skip("no C++ compiler to build the native loader")
    return True


def test_native_decoder_bit_equal_to_jax(tmp_path, native_ok):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    write_pgm(str(tmp_path / "a.pgm"), img)
    write_pgm(str(tmp_path / "b.pgm"), img[:8, :12], binary=False)
    write_ppm(str(tmp_path / "c.ppm"), rng.integers(0, 256, (16, 20, 3)).astype(np.uint8))
    for name, want_img in (("a.pgm", img), ("b.pgm", img[:8, :12]), ("c.ppm", None)):
        got = native_loader.read_image(str(tmp_path / name))
        want = jnl.read_image(str(tmp_path / name))
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), name
        if want_img is not None:
            assert np.array_equal(got, want_img.astype(np.float32))
    lib = native_loader.build()
    assert lib.parent.name == "build" and lib.parent.parent.name == "orbslam_in_practice_tpu_torch"


def test_prefetch_queue_order_and_missing_file(tmp_path, native_ok):
    rng = np.random.default_rng(4)
    paths, imgs = [], []
    for i in range(12):
        img = rng.integers(0, 256, (32, 40)).astype(np.uint8)
        write_pgm(str(tmp_path / f"f{i:03d}.pgm"), img)
        paths.append(str(tmp_path / f"f{i:03d}.pgm"))
        imgs.append(img)
    q = native_loader.PrefetchQueue(paths, prefetch=4, n_threads=3)
    seen = []
    for idx, img in q:
        seen.append(idx)
        assert np.array_equal(img, imgs[idx].astype(np.float32))
        assert np.array_equal(img, native_loader.read_image(paths[idx]))
    q.close()
    assert seen == list(range(12))
    assert native_loader.read_image(str(tmp_path / "missing.pgm")) is None


def test_viewer_and_stage_timer(tmp_path):
    from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor
    from orbslam_in_practice_tpu_torch.slam.map import SlamMap
    from orbslam_in_practice_tpu_torch.utils.viewer import render_frame, render_map

    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    ext = ORBExtractor(64, 1.2, 2, 20.0, 7.0)
    frame = ext(img)
    m = SlamMap(k_max=4, l_max=64, f_max=frame.n_features)
    m.add_keyframe(frame, np.eye(4, dtype=np.float32), np.full(frame.n_features, -1, np.int32), frame_id=0)
    ids = m.allocate_landmarks(8)
    m.add_landmarks(ids, rng.normal(size=(8, 3)).astype(np.float32) + [0, 0, 5.0], np.zeros((8, 256), np.int8),
                    np.zeros((8, 3), np.float32), np.zeros(8, np.int32), np.full(8, 0.1, np.float32),
                    np.full(8, 10.0, np.float32), first_kf=0)
    p1 = render_map(m, str(tmp_path / "map.png"), trajectory=np.zeros((3, 3)), title="map")
    p2 = render_frame(img, frame, str(tmp_path / "frame.png"), matches=frame.valid)
    from PIL import Image

    for p in (p1, p2):
        px = np.asarray(Image.open(p).convert("L"), np.float32)
        assert os.path.getsize(p) > 1000 and px.std() > 1.0, p
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("track"):
            pass
    with timer.stage("map"):
        pass
    s = timer.summary()
    assert s["track"]["count"] == 3 and s["map"]["count"] == 1 and s["track"]["total_s"] >= 0.0
    log = FrameLog(str(tmp_path / "log.jsonl"))
    log.log(frame=0, tracked=True)
    assert json.loads((tmp_path / "log.jsonl").read_text())["frame"] == 0 and len(log.records) == 1


def test_tum_layout_end_to_end(tmp_path, native_ok):
    """tests/test_e2e_real_data_glue.py::test_tum_layout_end_to_end through
    the port's run_slam on the CPU, frames as 8-bit PGM."""
    seq = SyntheticSequence(n_frames=N_GLUE)
    (tmp_path / "rgb").mkdir()
    gt = seq.gt_centers()
    with open(tmp_path / "rgb.txt", "w") as f, open(tmp_path / "groundtruth.txt", "w") as g:
        f.write("# color images\n# timestamp filename\n")
        g.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(N_GLUE):
            _write_pgm(str(tmp_path / "rgb" / f"{i:06d}.pgm"), np.clip(np.asarray(seq.render(i)), 0, 255))
            f.write(f"{1305031102.0 + 0.1 * i:.6f} rgb/{i:06d}.pgm\n")
            # ground truth 13 ms off the frames, as TUM's asynchronous 100 Hz
            c = gt[i]
            g.write(f"{1305031102.0 + 0.1 * i + 0.013:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} 0 0 0 1\n")
    (tmp_path / "cam.yaml").write_text(
        "%YAML:1.0\nCamera.fx: 500.0\nCamera.fy: 500.0\nCamera.cx: 320.0\nCamera.cy: 240.0\n"
        "ORBextractor.nFeatures: 800\nORBextractor.nLevels: 4\n"
    )
    ds = datasets.load_tum(str(tmp_path))
    assert len(ds) == N_GLUE and len(ds.gt_positions_for_frames()[0]) == N_GLUE
    files = {k: str(tmp_path / n) for k, n in (("traj", "traj.txt"), ("map", "map.npz"), ("log", "log.jsonl"),
                                               ("viz", "map.png"))}
    out = run_slam.main(["--tum", str(tmp_path), "--config", str(tmp_path / "cam.yaml"), "--device", "cpu",
                         "--traj-out", files["traj"], "--map-out", files["map"], "--log", files["log"],
                         "--viz", files["viz"]])
    assert out["frames"] == N_GLUE and out["tracked"] >= N_GLUE - 5, out["tracked"]
    assert out["aligned_frames"] >= 10 and out["ate_rmse"] < 0.10, out["ate_rmse"]
    assert len(np.loadtxt(files["traj"])) == out["tracked"]
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == N_GLUE
    assert os.path.getsize(files["map"]) > 0 and os.path.getsize(files["viz"]) > 1000
