"""What decides ``correct``: a sample, drawn from the seed, of what the
timed path produced in the window's first session, held against the plain
reference (``portbench/reference/``) worked out again from the same inputs.

The numbers, each with its limit in ``checks/<cell>.json`` (a cell
compares those its file names):

- ``kp_diff``, the extractor with both CUDA kernels: of the features of the
  sampled extractions (the initialisation extractor's on session frames 0
  and 1, the step's on frames drawn from ``check.after_first_pose``, frames
  counted from the session's first pose), the share
  whose validity, level-0 position or any BRIEF bit differs from the
  reference extractor's on the same frame as uploaded;
- ``pose_px``, the fused step (matcher and pose-only optimisation): on
  sampled fused frames, the reference step in float64 from the inputs the
  step received (the frame as uploaded, the map's landmark tables, the id
  lists, the last pose and velocity, copied as the step was called); the
  largest, over the frames, root-mean-square pixel gap between the two
  poses' projections of the step's inlier landmarks (a frame that one side
  tracks and the other does not reads ``MISS_PX``);
- ``tri_diff`` and ``tri_px``, new map points (``LocalMapper.
  create_new_points``: epipolar matching and triangulation against the
  covisible neighbours): over the first ``check.map_epochs`` keyframe
  epochs, the reference works each epoch's new landmarks out again in
  float64 from the map as the stage found it (``reference/mapping.py``);
  ``tri_diff`` is the share of new landmarks, as (feature, neighbour,
  neighbour's feature), that one side made and the other did not, and
  ``tri_px`` the largest pixel gap, in either keyframe, between the
  projections of a landmark both sides made;
- ``fuse_diff``, landmark fusion (``LocalMapper.fuse_neighbors``) at the
  same epochs: of the keyframe-observation entries that the program's
  fusion or the reference's changed, the share where the two tables
  differ afterwards (new observations and merges alike);
- ``untracked``, the tracker over the whole first session: the share of
  its window frames that got no pose, initialisation included (worked out
  by the harness from the poses returned);
- ``ba_short``, one local-BA epoch (``optim/ba.py``): the reference BA in
  float64 on the problem the epoch solved, as many LM iterations; how much
  of the reference's cost reduction the program's result falls short of,
  (cost(program) - cost(reference)) / (cost(input) - cost(reference)),
  the robust cost in float64: about 0 for a sound epoch, 1 for a BA that
  returns its input. The two results' RMS pixel gap (``ba_px``) and cost
  gap (``ba_cost``) are printed beside it and not compared: a fixed number
  of LM iterations whose accept test flips on a near tie between float32
  and float64 ends at another point of the valley (0.1 px and a 0.5% cost
  gap on one epoch of a dozen).

The step, the mapping stages and the BA are followed from the program's
own state (its map): the reference works out each stage again from what
that stage received. The control is the reference in the program's place in
the nearest lower precision: the extractor's pyramid and blur in bfloat16,
the step, the mapping stages and BA in float32 with TF32 matrix products.
``faults`` reads faults planted in the reference put in the program's
place: a step, a BA and mapping stages that return their state unchanged.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from portbench.reference import ba as ref_ba
from portbench.reference import mapping as ref_map
from portbench.reference.extract import extract
from portbench.reference.step import fused_step, reprojection_gap_px

MISS_PX = 1e3  # pose_px of a frame that only one side tracked


def encode(img: np.ndarray) -> np.ndarray:
    """A frame as the fused step uploads it: 8.8 fixed point."""
    return np.clip(np.asarray(img, np.float32) * 256.0, 0.0, 65535.0).astype(np.uint16)


class Recorder:
    """Keeps, without copying what the program does not change afterwards,
    what the timed path produced at the sampled frames of session 0: the
    extractors' outputs (forward hooks), the step's inputs (copied in a
    forward pre-hook, since the map's tables change later) and outputs, and
    the local-BA problems and results (``bundle_adjustment`` as
    ``slam/local_mapping.py`` calls it, wrapped to keep its arguments and
    return value), and the map before and after the first keyframe epochs'
    new-point and fusion stages (the local mapper's ``create_new_points``
    and ``fuse_neighbors``, wrapped on the instance)."""

    def __init__(self, mix_check: dict, seed: int):
        rng = np.random.default_rng([abs(int(seed)), 11])
        lo, hi = mix_check["after_first_pose"]
        span = np.arange(lo, hi)
        self.step_after = {int(x) for x in rng.choice(span, size=mix_check["step_samples"], replace=False)}
        self.extract_after = {int(x) for x in rng.choice(span, size=mix_check["extract_samples"], replace=False)}
        self.ba_max = int(mix_check["ba_epochs"])
        self.ba_pick = float(rng.uniform())
        self.map_max = int(mix_check["map_epochs"])
        self.frame = -1  # session 0's frame being tracked, -1 outside it
        self.first_pose = None  # session 0's first frame that got a pose
        self.in_step = False
        self.extractions = []  # (frame, "ini" | "step", in the fused step, Frame)
        self.steps = []  # (frame, inputs, Tcw, obs, ok)
        self.bas = []  # (problem, iterations, (poses, points, chi2))
        self.creates = []  # (kf_id, MapSnapshot before, {(f, nb, g): point} made)
        self.fuses = []  # (kf_id, MapSnapshot before, kf_obs after)
        self._handles = []
        self._restore = None
        self._mapper = None
        self._pending = None

    def attach(self, system) -> None:
        tr = system.tracker
        self._handles = [
            tr.step.register_forward_pre_hook(self._step_pre),
            tr.step.register_forward_hook(self._step_post),
            tr.extractor.register_forward_hook(self._extract_hook("step")),
            tr.ini_extractor.register_forward_hook(self._extract_hook("ini")),
        ]
        import orbslam_in_practice_tpu_torch.slam.local_mapping as lm

        orig = lm.bundle_adjustment

        def bundle_adjustment(prob, *args, **kwargs):
            out = orig(prob, *args, **kwargs)
            if self.frame >= 0 and len(self.bas) < self.ba_max:
                self.bas.append((prob, kwargs.get("iterations", args[0] if args else 20), out))
            return out

        lm.bundle_adjustment = bundle_adjustment
        self._restore = (lm, orig)
        self._mapper = tr.mapper
        tr.mapper.create_new_points = self._stage_hook(tr.mapper.create_new_points, self.creates, _created)
        tr.mapper.fuse_neighbors = self._stage_hook(tr.mapper.fuse_neighbors, self.fuses, _fused)

    def detach(self) -> None:
        """Remove the hooks and the wrapper (again: a no-op)."""
        for h in self._handles:
            h.remove()
        self._handles = []
        if self._restore is not None:
            mod, orig = self._restore
            mod.bundle_adjustment = orig
            self._restore = None
        if self._mapper is not None:
            for name in ("create_new_points", "fuse_neighbors"):
                self._mapper.__dict__.pop(name, None)
            self._mapper = None
        self.frame = -1

    def _stage_hook(self, stage, kept: list, after):
        """``stage`` (a bound method of the local mapper), keeping the map
        as the stage found it and what it made of it, ``after(smap, kf_id,
        snapshot)``, for the first ``map_max`` epochs of session 0 (not the
        loop closer's fusion, which names its own neighbours)."""
        def wrapped(smap, kf_id, *args, **kwargs):
            if self.frame < 0 or len(kept) >= self.map_max or args or kwargs.get("neighbors") is not None:
                return stage(smap, kf_id, *args, **kwargs)
            snap = snapshot(smap, int(kf_id))
            out = stage(smap, kf_id, *args, **kwargs)
            kept.append((int(kf_id), snap, after(smap, int(kf_id), snap)))
            return out

        return wrapped

    def _after_first_pose(self, offsets: set) -> bool:
        return self.first_pose is not None and self.frame - self.first_pose in offsets

    def _step_pre(self, module, args):
        self.in_step = True
        if self.frame >= 0 and self._after_first_pose(self.step_after):
            self._pending = tuple(a.clone() for a in args)

    def _step_post(self, module, args, out):
        self.in_step = False
        if self._pending is not None:
            self.steps.append((self.frame, self._pending, out[1], out[2], out[5]))
            self._pending = None

    def _extract_hook(self, which: str):
        def hook(module, args, out):
            if self.frame in (0, 1) or (self.frame >= 0 and self._after_first_pose(self.extract_after)):
                self.extractions.append((self.frame, which, self.in_step, out))

        return hook


def snapshot(smap, kf_id: int) -> ref_map.MapSnapshot:
    """Copies of the map's host tables that the new-point and fusion stages
    of keyframe ``kf_id`` read."""
    n = smap.n_kf
    covis = smap.covisibility()[kf_id].copy()
    rows = {k: {name: smap.hview("kf_" + name)[k].copy()
                for name in ("pose", "xy", "octave", "angle", "feat_valid", "desc_pm1")}
            for k in {kf_id, *ref_map.neighbour_candidates(covis)}}
    return ref_map.MapSnapshot(
        kf_obs=smap.hview("kf_obs")[:n].copy(), kf_valid=smap.hview("kf_valid")[:n].copy(), covis_row=covis,
        rows=rows, lm_pos=smap.hview("lm_pos").copy(), lm_valid=smap.hview("lm_valid").copy(),
        lm_desc_pm1=smap.hview("lm_desc_pm1").copy(), lm_octave=smap.hview("lm_octave").copy(),
        lm_obs_count=smap.lm_obs_count.copy())


def _created(smap, kf_id: int, snap: ref_map.MapSnapshot) -> dict:
    """The landmarks the new-point stage made, read back from the map:
    {(feature, neighbour, neighbour's feature): world point}."""
    pre = snap.kf_obs
    post = smap.hview("kf_obs")[: pre.shape[0]]
    made = (pre < 0) & (post >= 0)
    where = {}
    for r, g in zip(*np.nonzero(made)):
        if r != kf_id:
            where.setdefault(int(post[r, g]), []).append((int(r), int(g)))
    pos = smap.hview("lm_pos")
    out = {}
    for f in np.nonzero(made[kf_id])[0]:
        lm = int(post[kf_id, f])
        for r, g in where.get(lm, [(-1, -1)]):
            out[(int(f), r, g)] = pos[lm].astype(np.float64)
    return out


def _fused(smap, kf_id: int, snap: ref_map.MapSnapshot) -> np.ndarray:
    """The keyframe-observation table after the fusion stage."""
    return smap.hview("kf_obs")[: snap.kf_obs.shape[0]].copy()


def _settings_K(settings: dict) -> np.ndarray:
    return np.array([[settings["fx"], 0.0, settings["cx"]], [0.0, settings["fy"], settings["cy"]], [0.0, 0.0, 1.0]])


def _tri_numbers(snap: ref_map.MapSnapshot, kf_id: int, prog: dict, ref: dict, K: np.ndarray) -> tuple:
    """(landmarks one side made and the other did not, landmarks either
    made, the largest pixel gap between the two sides' points of a landmark
    both made, in either keyframe)."""
    both = prog.keys() & ref.keys()
    gap = 0.0
    for key in both:
        for k in (kf_id, key[1]):
            T = snap.rows[k]["pose"].astype(np.float64)
            uv = []
            for X in (prog[key], ref[key]):
                pc = T[:3, :3] @ X + T[:3, 3]
                uv.append((K @ (pc / max(pc[2], 1e-9)))[:2])
            gap = max(gap, float(np.linalg.norm(uv[0] - uv[1])))
    return len(prog.keys() ^ ref.keys()), len(prog.keys() | ref.keys()), gap


def _fuse_numbers(snap: ref_map.MapSnapshot, prog: np.ndarray, ref: np.ndarray) -> tuple:
    """(entries where the two tables differ after fusion, entries either
    side changed)."""
    changed = (prog != snap.kf_obs) | (ref != snap.kf_obs)
    return int((prog != ref).sum()), int(changed.sum())


def _map_numbers(rec, settings: dict, device, made_create=None, made_fuse=None, dtype=torch.float64) -> dict:
    """``tri_diff``, ``tri_px`` and ``fuse_diff`` pooled over the kept
    epochs: the program's results, or ``made_create(kf_id, snap)`` and
    ``made_fuse(kf_id, snap)`` in their place, against the reference."""
    K = _settings_K(settings)
    sf, nl = settings["scale_factor"], settings["n_levels"]
    d_tri = n_tri = d_fuse = n_fuse = 0
    gap = 0.0
    for kf_id, snap, prog in rec.creates:
        ref = ref_map.create_points(snap, kf_id, K, sf, nl, torch.float64, device)
        if made_create is not None:
            prog = made_create(kf_id, snap)
        d, n, g = _tri_numbers(snap, kf_id, prog, ref, K)
        d_tri, n_tri, gap = d_tri + d, n_tri + n, max(gap, g)
    for kf_id, snap, prog in rec.fuses:
        ref = ref_map.fuse(snap, kf_id, K, sf, nl, torch.float64, device)
        if made_fuse is not None:
            prog = made_fuse(kf_id, snap)
        d, n = _fuse_numbers(snap, prog, ref)
        d_fuse, n_fuse = d_fuse + d, n_fuse + n
    return {"tri_diff": d_tri / n_tri if n_tri else (0.0 if rec.creates else None),
            "tri_px": gap if rec.creates else None, "tri_made": n_tri,
            "fuse_diff": d_fuse / n_fuse if n_fuse else (0.0 if rec.fuses else None), "fuse_changed": n_fuse}


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _ba_problem(prob, dtype) -> ref_ba.BAProblem:
    return ref_ba.BAProblem(**{
        k: (v.to(dtype) if v.is_floating_point() else v) for k, v in prob._asdict().items()
    })


def _ba_gap_px(prob, a, b) -> float:
    """RMS pixel gap between the projections of the problem's masked
    observations under the results ``a`` and ``b`` ((poses, points))."""
    p = _ba_problem(prob, torch.float64)
    ra = ref_ba._proj_residual_jac(a[0].double(), a[1].double(), p.obs_cam, p.obs_point, p.obs_uv, p.K)[0]
    rb = ref_ba._proj_residual_jac(b[0].double(), b[1].double(), p.obs_cam, p.obs_point, p.obs_uv, p.K)[0]
    m = p.obs_mask
    if not bool(m.any()):
        return 0.0
    d = (ra - rb)[m]
    return float(torch.sqrt(torch.mean(torch.sum(d * d, dim=-1))))


def _ba_cost(prob, result) -> float:
    """The problem's robust cost (float64) at ``result`` ((poses,
    points)), over the observations the solver uses."""
    p = _ba_problem(prob, torch.float64)
    w = (p.obs_mask & ref_ba.included_obs_mask(p.point_obs, p.obs_cam.shape[0])).double()
    return float(ref_ba._total_cost(result[0].double(), result[1].double(), p, w))


def _ba_cost_gap(prob, prog, ref) -> float:
    """|cost(program's result) - cost(reference's)| / cost(reference's)."""
    c_ref = _ba_cost(prob, ref)
    return abs(_ba_cost(prob, prog) - c_ref) / max(c_ref, 1e-30)


def _ba_shortfall(prob, prog, ref) -> float:
    """(cost(program's result) - cost(reference's)) / (cost(input) -
    cost(reference's)): the share of the reference's reduction the program
    fell short of (negative where it went lower)."""
    c_in, c_ref = _ba_cost(prob, (prob.poses, prob.points)), _ba_cost(prob, ref)
    return (_ba_cost(prob, prog) - c_ref) / max(c_in - c_ref, 1e-30 * max(c_ref, 1.0))


def evaluate(rec: Recorder, frames: list, settings: dict, device, control: bool = False) -> dict:
    """The numbers. With ``control`` the lower-precision reference
    stands in the program's place and is held against the reference."""
    n, n_levels, sf = settings["n_features"], settings["n_levels"], settings["scale_factor"]
    ini, mn = settings["ini_th_fast"], settings["min_th_fast"]
    out = {}

    # the extractor
    differ = total = 0
    for i, which, in_step, prog in rec.extractions:
        img = frames[i]
        img = torch.from_numpy(encode(img)).to(device).to(torch.float32) * (1.0 / 256.0) if in_step else \
            torch.from_numpy(np.asarray(img, np.float32)).to(device)
        budget = 2 * n if which == "ini" else n
        ref = extract(img, budget, n_levels, sf, ini, mn)
        if control:
            low = extract(img, budget, n_levels, sf, ini, mn, control=True)
            valid, xy, bits = low.valid, low.xy_raw, low.bits
        else:
            valid, xy, bits = prog.valid, prog.xy_raw, prog.desc_pm1 > 0
        bad = (valid != ref.valid) | (ref.valid & ((xy != ref.xy_raw).any(-1) | (bits != ref.bits).any(-1)))
        differ += int(bad.sum())
        total += int((valid | ref.valid).sum())
    out["kp_diff"] = differ / total if total else None

    # the fused step
    gaps = []
    for _, inputs, Tcw, obs, ok in rec.steps:
        ref_T, _, ref_ok = fused_step(settings, *inputs, dtype=torch.float64)
        if control:
            with _tf32(True):
                Tcw, obs, ok = fused_step(settings, *inputs, dtype=torch.float32)
        ok = bool(ok)
        if ok != ref_ok:
            gaps.append(MISS_PX)
        elif ok:
            lm_pos = inputs[4]
            ids = obs[obs >= 0].long()
            K = torch.tensor([[settings["fx"], 0.0, settings["cx"]], [0.0, settings["fy"], settings["cy"]],
                              [0.0, 0.0, 1.0]], dtype=torch.float64, device=device)
            gaps.append(reprojection_gap_px(Tcw, ref_T, lm_pos[ids], K))
    out["pose_px"] = max(gaps) if gaps else None
    out["pose_px_median"] = float(np.median(gaps)) if gaps else None

    # one local-BA epoch, drawn from the seed among those kept
    if rec.bas:
        prob, iters, prog_out = rec.bas[min(int(rec.ba_pick * len(rec.bas)), len(rec.bas) - 1)]
        ref_out = ref_ba.bundle_adjustment(_ba_problem(prob, torch.float64), iterations=iters)
        if control:
            with _tf32(True):
                prog_out = ref_ba.bundle_adjustment(_ba_problem(prob, torch.float32), iterations=iters)
        out["ba_px"] = _ba_gap_px(prob, prog_out[:2], ref_out[:2])
        out["ba_cost"] = _ba_cost_gap(prob, prog_out[:2], ref_out[:2])
        out["ba_short"] = _ba_shortfall(prob, prog_out[:2], ref_out[:2])
    else:
        out["ba_px"] = out["ba_cost"] = out["ba_short"] = None

    # the first epochs' new points and fusion
    if control:
        K, sf, nl = _settings_K(settings), settings["scale_factor"], settings["n_levels"]
        with _tf32(True):
            out.update(_map_numbers(
                rec, settings, device,
                lambda k, snap: ref_map.create_points(snap, k, K, sf, nl, torch.float32, device),
                lambda k, snap: ref_map.fuse(snap, k, K, sf, nl, torch.float32, device)))
    else:
        out.update(_map_numbers(rec, settings, device))
    return out


def faults(rec: Recorder, settings: dict, device) -> dict:
    """``pose_px``, the BA's and the mapping stages' numbers of a step that
    returns the last pose it was given, a BA that returns its problem's
    input, and new-point and fusion stages that leave the map as they found
    it, held against the reference."""
    gaps = []
    K = torch.tensor([[settings["fx"], 0.0, settings["cx"]], [0.0, settings["fy"], settings["cy"]],
                      [0.0, 0.0, 1.0]], dtype=torch.float64, device=device)
    for _, inputs, _, obs, ok in rec.steps:
        ref_T, _, ref_ok = fused_step(settings, *inputs, dtype=torch.float64)
        if bool(ok) and ref_ok:
            gaps.append(reprojection_gap_px(inputs[3], ref_T, inputs[4][obs[obs >= 0].long()], K))
    out = {"stale_step_pose_px": max(gaps) if gaps else None}
    if rec.bas:
        prob, iters, _ = rec.bas[min(int(rec.ba_pick * len(rec.bas)), len(rec.bas) - 1)]
        ref_out = ref_ba.bundle_adjustment(_ba_problem(prob, torch.float64), iterations=iters)
        out["unchanged_ba_px"] = _ba_gap_px(prob, (prob.poses, prob.points), ref_out[:2])
        out["unchanged_ba_cost"] = _ba_cost_gap(prob, (prob.poses, prob.points), ref_out[:2])
        out["unchanged_ba_short"] = _ba_shortfall(prob, (prob.poses, prob.points), ref_out[:2])
    unchanged = _map_numbers(rec, settings, device, lambda k, snap: {}, lambda k, snap: snap.kf_obs.copy())
    out["unchanged_tri_diff"], out["unchanged_fuse_diff"] = unchanged["tri_diff"], unchanged["fuse_diff"]
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limited number present,
    finite and at most its limit."""
    rows = [(name, numbers.get(name), lim["limit"]) for name, lim in limits.items()]
    ok = all(v is not None and math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
