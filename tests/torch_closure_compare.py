"""Both packages' loop detection and Sim(3) verification on one map of the port.

    python tests/torch_closure_compare.py [REGIME] [FRAME]

Runs the port's ``SlamSystem`` on the CPU over the regime REGIME of
``orbslam_in_practice_tpu_torch/regimes.py`` (default ``kitti_loop``) until
the loop closer's attempt at the keyframe of frame FRAME (default 191),
saves that map with ``save_map`` and loads it into both packages (the file
holds no global descriptors: each package computes them from the
keyframes' features, as at insertion). It then prints, as JSON lines, each
package's loop candidates for that keyframe and, for every candidate either
package finds, ``compute_sim3`` of the JAX package, the port's with the
same RANSAC draws (``torch_parity.injected_jax_draws``) and the port's with
its own draws. Equal candidates and equal results under the same draws mean
a closure the port makes there is the JAX package's too, given the same
map. ``kitti_loop`` to frame 191 takes about 6 minutes.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.dirname(os.path.abspath(__file__))]
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def port_map_at(name: str, frame: int, path: str) -> int:
    """Track the regime on the CPU until the loop closer's attempt at the
    keyframe of ``frame``; save the map there to ``path``. Returns the
    keyframe's slot."""
    import torch

    from orbslam_in_practice_tpu_torch import regimes
    from orbslam_in_practice_tpu_torch.slam.loop_closing import LoopCloser
    from orbslam_in_practice_tpu_torch.system import SlamSystem
    from orbslam_in_practice_tpu_torch.utils.checkpoint import save_map

    class Reached(Exception):
        pass

    seq, cfg, n = regimes.build(name)
    attempt = LoopCloser.attempt

    def saving_attempt(self, smap, kf_id, mapper):
        if int(smap.kf_frame_id[kf_id]) == frame:
            save_map(path, smap)
            raise Reached(kf_id)
        return attempt(self, smap, kf_id, mapper)

    system = SlamSystem(cfg, device="cpu")
    LoopCloser.attempt = saving_attempt
    try:
        with torch.no_grad():
            for i in range(min(frame + 1, n)):
                system.track_monocular(seq.render(i), 0.1 * i)
    except Reached as reached:
        return int(reached.args[0])
    finally:
        LoopCloser.attempt = attempt
    raise SystemExit(f"no loop-closure attempt at a keyframe of frame {frame}")


def compare(name: str, path: str, kf: int) -> None:
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch
    from torch_parity import injected_jax_draws

    from orbslam_in_practice_tpu.slam import loop_closing as jlc
    from orbslam_in_practice_tpu.slam.map import SlamMap as JaxMap
    from orbslam_in_practice_tpu.slam.place_recognition import global_descriptor as jax_global_descriptor
    from orbslam_in_practice_tpu.utils.checkpoint import load_map as jax_load_map
    from orbslam_in_practice_tpu_torch import regimes
    from orbslam_in_practice_tpu_torch.slam.loop_closing import LoopCloser
    from orbslam_in_practice_tpu_torch.utils.checkpoint import load_map

    _, cfg, _ = regimes.build(name)
    import torch_regime_reference

    _, jcfg, _ = torch_regime_reference.build(name)
    tmap = load_map(path, "cpu")
    jmap = JaxMap(cfg.k_max, cfg.l_max, tmap.f_max)
    jax_load_map(path, jmap)
    desc, valid = np.asarray(jmap.kf_desc_pm1), np.asarray(jmap.kf_feat_valid)
    for k in np.nonzero(jmap.kf_valid_host())[0]:
        jmap._kf_gdesc[k] = np.asarray(jax_global_descriptor(jnp.asarray(desc[k]), jnp.asarray(valid[k])))
        jmap._touch_row("kf_gdesc", int(k))
    frame_of = lambda k: int(tmap.kf_frame_id[k])  # noqa: E731
    want = jlc.LoopCloser(jcfg).detect_candidates(jmap, kf)
    got = LoopCloser(cfg, "cpu").detect_candidates(tmap, kf)
    print(json.dumps({"keyframe": kf, "frame": frame_of(kf), "jax_candidates": want, "port_candidates": got,
                      "candidate_frames": [frame_of(c) for c in got]}))
    mp = MonkeyPatch()
    try:
        for cand in sorted(set(want) | set(got)):
            with injected_jax_draws(mp, jlc, "_sim3_ransac") as draws:
                j = jlc.LoopCloser(jcfg).compute_sim3(jmap, kf, cand)
            t = LoopCloser(cfg, "cpu").compute_sim3(tmap, kf, cand, sample_idx={s - 2: d for s, d in draws.items()})
            own = LoopCloser(cfg, "cpu").compute_sim3(tmap, kf, cand)
            row = {"candidate": cand, "candidate_frame": frame_of(cand)}
            for label, r in (("jax", j), ("port_same_draws", t), ("port_own_draws", own)):
                row[label] = {"ok": bool(r[0]), "inliers": int(r[4]), "scale": None if r[1] is None else float(r[1])}
            print(json.dumps(row))
    finally:
        mp.undo()


if __name__ == "__main__":
    regime = sys.argv[1] if len(sys.argv) > 1 else "kitti_loop"
    at = int(sys.argv[2]) if len(sys.argv) > 2 else 191
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "map.npz")
        compare(regime, npz, port_map_at(regime, at, npz))
