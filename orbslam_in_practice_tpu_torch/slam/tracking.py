"""Tracking: the per-frame state machine, around the fused steady-state step.

Port of ``orbslam_in_practice_tpu/slam/tracking.py``. ``Tracking`` runs the
5-state machine on the host: two-view initialisation from the first frames
(doubled feature budget), then per frame the fused steady-state step, with
the unfused flow (reference-keyframe tracking, local-map tracking) as its
fallback, the keyframe decision and insertion, a synchronous local-mapping
epoch per keyframe followed by a loop-closure attempt, and relocalisation
when lost with more than 5 keyframes. With ``async_mapping=True`` the
epochs and loop closing run in a worker thread (``slam/async_mapping.py``)
while tracking goes on: the keyframe decision throttles on the worker's
queue, and a closure the worker found re-anchors the tracker as soon as
tracking next takes the map lock (before it tracks, or before its keyframe
decision when the closure landed while the fused step ran).

``FusedSteadyStep`` is ``Tracking._build_fused_steady``: decode the 8.8
fixed-point image -> ORB extraction -> motion-model projection match
(radius 15, with a retry at radius 30) -> pose-only BA -> local-map
projection match (radius 4, landmark invariants) -> pose-only BA ->
velocity update. Same 11 inputs and 7 outputs. The reference's
``lax.cond`` retry becomes both matches computed and one picked by
``torch.where``; like the fixed-step pose optimisation, this keeps the
step free of host synchronisation.

Each stage runs inside a ``torch.profiler.record_function`` span (the
step's extract, match_motion_r15, match_motion_r30, pose_opt_motion,
match_local, pose_opt_local; initialisation's init_twoview and
init_global_ba; relocalisation's reloc; the loop closer's lc_detect,
lc_sim3, lc_correct and lc_global_ba), which ``profile_step.py`` reads; a
span costs a few microseconds of host time when no profiler is running.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from orbslam_in_practice_tpu_torch.frontend.matcher import (
    search_by_projection,
    search_for_initialization,
    search_frame_to_kf,
)
from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor
from orbslam_in_practice_tpu_torch.ops.orb import level_budgets
from orbslam_in_practice_tpu_torch.optim.ba import BAProblem, build_point_obs, bundle_adjustment
from orbslam_in_practice_tpu_torch.optim.pose_opt import pose_optimization
from orbslam_in_practice_tpu_torch.slam.async_mapping import AsyncMapperDriver
from orbslam_in_practice_tpu_torch.slam.initializer import initialize_two_view
from orbslam_in_practice_tpu_torch.slam.local_mapping import LocalMapper
from orbslam_in_practice_tpu_torch.slam.loop_closing import LoopCloser
from orbslam_in_practice_tpu_torch.slam.map import SlamMap, _host
from orbslam_in_practice_tpu_torch.slam.relocalization import relocalize

LOCAL_MAP_MAX = 4096  # padded local-map landmark budget
INIT_BA_ITERATIONS = 20  # LM iterations of the two-keyframe global BA


def encode_image(img: np.ndarray) -> np.ndarray:
    """float32 [0, 255] grayscale -> the step's 8.8 fixed-point uint16."""
    return np.clip(np.asarray(img, np.float32) * 256.0, 0.0, 65535.0).astype(np.uint16)


def _obs_from_matches(n_features: int, matches, ids, lm_pos):
    """Per frame feature: the global id and position of the landmark matched
    to it (the highest matching point index wins), and whether it has one."""
    n_set = matches.shape[0]
    point = torch.arange(n_set, dtype=torch.int64, device=matches.device)
    obs_loc = torch.full((n_features,), -1, dtype=torch.int64, device=matches.device)
    obs_loc.scatter_reduce_(
        0, torch.clamp(matches.long(), min=0), torch.where(matches >= 0, point, -1),
        reduce="amax", include_self=True,
    )
    has = obs_loc >= 0
    sel = ids[torch.clamp(obs_loc, min=0)]
    return torch.where(has, sel, -1), lm_pos[sel], has


class FusedSteadyStep(nn.Module):
    """One steady-state frame: owns the extractor and the step's constant
    tables (K, the scale factors and the per-octave information weights).

    ``f_max``, the length of the motion-model id list, is the map's
    per-keyframe feature budget, which the reference sizes for the
    doubled-budget initialisation extractor.
    """

    def __init__(self, cfg, use_kernels: bool = True):
        super().__init__()
        self.n_levels = cfg.n_levels
        self.extractor = ORBExtractor(
            cfg.n_features, cfg.scale_factor, cfg.n_levels, cfg.ini_th_fast, cfg.min_th_fast,
            cam=cfg.cam, use_kernels=use_kernels,
        )
        self.f_max = sum(level_budgets(2 * cfg.n_features, cfg.n_levels, cfg.scale_factor))
        scale_factors = np.array([cfg.scale_factor**i for i in range(cfg.n_levels)], np.float32)
        self.register_buffer("K", cfg.cam.K())
        self.register_buffer("scale_factors", torch.from_numpy(scale_factors))

    def forward(
        self, image, packed_ids, velocity, last_pose,
        lm_pos, lm_desc, lm_valid, lm_oct, lm_normal, lm_mind, lm_maxd,
    ):
        """image: (H, W) uint16, 8.8 fixed point. packed_ids: int32
        [mm_ids (f_max) | loc_ids (LOCAL_MAP_MAX) | mm_n | loc_n]. velocity,
        last_pose: (4, 4). lm_*: the landmark tables (l_max rows).

        Returns (frame, Tcw, obs (N,) landmark id per feature or -1,
        velocity, ok1 (motion model tracked), ok (frame tracked), n_inliers).
        """
        F, K, sf = self.f_max, self.K, self.scale_factors
        ids = packed_ids.long()
        mm_ids = ids[:F]
        loc_ids = ids[F : F + LOCAL_MAP_MAX]
        mm_n = ids[F + LOCAL_MAP_MAX]
        loc_n = ids[F + LOCAL_MAP_MAX + 1]
        with record_function("extract"):
            frame = self.extractor(image.to(torch.float32) * (1.0 / 256.0))
        inv_s2 = self.extractor.inv_level_sigma2[torch.clamp(frame.octave.long(), 0, self.n_levels - 1)]
        pred = velocity @ last_pose

        # stage 1: motion model, retried at radius 30 below 20 matches
        arange = torch.arange(max(F, LOCAL_MAP_MAX), device=ids.device)
        v1 = (arange[:F] < mm_n) & lm_valid[mm_ids]
        p1, d1, o1 = lm_pos[mm_ids], lm_desc[mm_ids], lm_oct[mm_ids]
        with record_function("match_motion_r15"):
            m15 = search_by_projection(p1, d1, v1, o1, pred, frame, K, 15.0, sf)[0]
        with record_function("match_motion_r30"):
            m30 = search_by_projection(p1, d1, v1, o1, pred, frame, K, 30.0, sf)[0]
        m1 = torch.where(torch.sum(m15 >= 0) >= 20, m15, m30)
        n_match1 = torch.sum(m1 >= 0)
        n_feat = frame.n_features
        with record_function("pose_opt_motion"):
            _, Xw1, has1 = _obs_from_matches(n_feat, m1, mm_ids, lm_pos)
            Tcw1, _, n1 = pose_optimization(pred, Xw1, frame.xy, inv_s2, has1 & frame.valid, K)
        ok1 = (n_match1 >= 20) & (n1 >= 10)
        Tcw1 = torch.where(ok1, Tcw1, pred)

        # stage 2: local map, seeded by stage 1's pose
        v2 = (arange[:LOCAL_MAP_MAX] < loc_n) & lm_valid[loc_ids]
        with record_function("match_local"):
            m2 = search_by_projection(
                lm_pos[loc_ids], lm_desc[loc_ids], v2, lm_oct[loc_ids], Tcw1, frame, K, 4.0, sf,
                pts_normal=lm_normal[loc_ids],
                pts_min_dist=lm_mind[loc_ids],
                pts_max_dist=lm_maxd[loc_ids],
            )[0]
        with record_function("pose_opt_local"):
            obs2, Xw2, has2 = _obs_from_matches(n_feat, m2, loc_ids, lm_pos)
            Tcw2, inl2, n2 = pose_optimization(Tcw1, Xw2, frame.xy, inv_s2, has2 & frame.valid, K)
        obs2 = torch.where(inl2, obs2, -1).to(torch.int32)
        ok = ok1 & (n2 >= 30)
        velocity_new = Tcw2 @ torch.linalg.inv_ex(last_pose)[0]
        return frame, Tcw2, obs2, velocity_new, ok1, ok, n2


class TrackingState(Enum):
    """ORB-SLAM's tracking states."""

    NOT_READY = 0
    NO_IMAGES = 1
    NOT_INITIALIZED = 2
    OK = 3
    LOST = 4


def _pad_ids(ids: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, np.int32)
    out[: min(len(ids), n)] = ids[:n]
    return out


class Tracking:
    """The tracking state machine on one device.

    ``use_fused`` (default True) routes steady-state frames through
    ``FusedSteadyStep``; False runs the unfused per-stage flow on every
    frame. ``n_fused_frames`` counts the frames the fused step ran on.

    After each frame, ``frame_path`` names the path it took: 'init'
    (initialisation), 'fused' (the fused step alone), 'fused_fallback' (the
    fused step, then reference-keyframe tracking), 'unfused' (the unfused
    flow only), 'reloc' (lost: relocalisation tried) or 'reset' (lost
    early: the map was reset); and
    ``frame_keyframe`` says whether it inserted a keyframe (and so ran a
    local-mapping epoch, or queued it for the worker).

    ``async_driver`` is the mapping worker when ``config.async_mapping``,
    else None.

    As in the JAX package, ``cam`` is the configuration's camera,
    ``last_frame`` the last tracked frame (the extractor's or the fused
    step's own outputs, never rows of the map's tables) and ``new_kf_ids``
    every keyframe slot inserted, in order; ``reset`` clears neither.
    """

    def __init__(self, config, device: torch.device | str = "cuda"):
        self.cfg = config
        self.cam = config.cam
        self.device = torch.device(device)
        self.K = self.cam.K(self.device)
        self.step = FusedSteadyStep(config).to(self.device)
        self.extractor = self.step.extractor
        # doubled feature budget for initialisation
        self.ini_extractor = ORBExtractor(
            2 * config.n_features, config.scale_factor, config.n_levels, config.ini_th_fast,
            config.min_th_fast, cam=config.cam,
        ).to(self.device)
        self.scale_factors = self.step.scale_factors
        self.inv_level_sigma2 = self.extractor.inv_level_sigma2
        self.map = self._new_map()
        self.mapper = LocalMapper(config, self.device)
        self.loop_closer = LoopCloser(config, self.device) if config.enable_loop_closing else None

        self.state = TrackingState.NO_IMAGES
        self.frame_id = -1
        self.last_frame = None  # the last tracked Frame, on the device
        self.last_pose = None  # (4, 4) Tcw of the last frame, on the device
        self._prev_pose = None
        self.last_obs = None  # (F,) landmark id per feature of the last frame (host)
        self.velocity = None  # (4, 4) Tcw_cur @ inv(Tcw_last), on the device
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self._peak_inliers_since_kf = 0
        self.last_reloc_frame_id = -(10**9)
        self._init_frame = None
        self._init_frame_id = -1
        self._prev_matched = None
        # trajectory log: (frame_id, timestamp, Tcw or None, ref_kf,
        # T_rel = Tcw_frame @ inv(Tcw_refkf at track time), ref_kf seq);
        # anchoring to the keyframe lets later BA refine past frames
        self.trajectory: list = []
        self.n_inliers = 0
        self.n_local_map_truncations = 0
        self.new_kf_ids: list = []
        self.use_fused = True
        self.n_fused_frames = 0
        self.frame_path = None
        self.frame_keyframe = False
        # a loop closure posted by the worker, (ref_kf, ref_seq, pose_before),
        # read and cleared under the map lock
        self._pending_closure_rebase = None
        self.async_driver = AsyncMapperDriver(self) if config.async_mapping else None

    def _new_map(self) -> SlamMap:
        return self.adopt_map(SlamMap(self.cfg.k_max, self.cfg.l_max, self.step.f_max, device=self.device))

    def adopt_map(self, smap: SlamMap) -> SlamMap:
        """Make ``smap`` the tracker's map (a new one, or one loaded from a
        checkpoint): keyframe removals re-anchor the trajectory."""
        smap.on_kf_removed = self._reanchor_trajectory
        self.map = smap
        return smap

    # ------------------------------------------------------------------
    def reset(self):
        """Start over with an empty map; trajectory entries so far are frozen
        at their absolute poses (re-anchored through the old map first).
        Queued mapping epochs finish against the old map first."""
        if self.async_driver is not None:
            self.async_driver.drain()
            self._pending_closure_rebase = None
        old_map = self.map
        self.map = self._new_map()
        self.mapper = LocalMapper(self.cfg, self.device)
        if self.loop_closer is not None:
            self.loop_closer = LoopCloser(self.cfg, self.device)
        self.state = TrackingState.NOT_INITIALIZED
        self.last_pose = None
        self.last_obs = None
        self.velocity = None
        self.ref_kf = -1
        self._init_frame = None
        self._prev_matched = None
        old_valid = old_map.kf_valid_host()
        old_pose = old_map.hview("kf_pose")
        old_seq = old_map.kf_seq
        frozen = []
        for fid, ts, pose, ref, T_rel, seq in self.trajectory:
            if pose is not None and ref >= 0 and T_rel is not None and old_valid[ref] and old_seq[ref] == seq:
                pose = T_rel @ old_pose[ref]
            frozen.append((fid, ts, pose, -1, None, -1))
        self.trajectory = frozen

    # ------------------------------------------------------------------
    def track_mono(self, image: np.ndarray, timestamp: float):
        """One frame: image (H, W) float32 grayscale in [0, 255].
        Returns the frame's Tcw (4, 4) numpy, or None when not tracked."""
        self.frame_id += 1
        self.frame_keyframe = False
        if self.async_driver is not None:
            self.async_driver.raise_errors()
        if self.use_fused and self.state == TrackingState.OK and self.velocity is not None and self.last_obs is not None:
            n_fused = self.n_fused_frames
            status, frame, pose = self._track_frame_fused(image)
            launched = self.n_fused_frames > n_fused
            self.frame_path = "fused_fallback" if status == "stage1" and launched else "fused" if launched else "unfused"
            if status == "stage2":  # local-map tracking failed: lost
                self.state = TrackingState.LOST
                self.velocity = None
            elif status == "stage1":  # motion model failed: reference keyframe
                if frame is None:
                    frame = self.extractor(self._to_device(image))
                with self.map.lock:
                    pose = self.last_pose if self._track_frame(frame, try_motion=False) else None
            with self.map.lock:
                if pose is None:
                    self.trajectory.append((self.frame_id, timestamp, None, -1, None, -1))
                    return None
                return self._log_pose(pose, timestamp)

        initializing = self.state in (TrackingState.NO_IMAGES, TrackingState.NOT_INITIALIZED)
        self.frame_path = "init" if initializing else "unfused" if self.state == TrackingState.OK else "reset"
        extractor = self.ini_extractor if initializing else self.extractor
        frame = extractor(self._to_device(image))
        if self.state == TrackingState.NO_IMAGES:
            self.state = TrackingState.NOT_INITIALIZED

        if self.state == TrackingState.NOT_INITIALIZED:
            with self.map.lock:
                self._monocular_initialization(frame)
            pose = self.last_pose if self.state == TrackingState.OK else None
        elif self.state == TrackingState.OK:
            with self.map.lock:
                pose = self.last_pose if self._track_frame(frame) else None
        else:  # LOST
            with self.map.lock:
                self._consume_async_events()
                relocalizable = self.map.n_kf_active() > 5
                if relocalizable:
                    self.frame_path = "reloc"
                    pose = self.last_pose if self._relocalize(frame) else None
            if not relocalizable:
                # lost soon after initialisation: a small map is cheaper to
                # rebuild than to relocalise against
                self.reset()
                pose = None

        with self.map.lock:
            if pose is None:
                self.trajectory.append((self.frame_id, timestamp, None, -1, None, -1))
                return None
            return self._log_pose(pose, timestamp)

    def _to_device(self, image) -> torch.Tensor:
        return torch.as_tensor(np.asarray(image, np.float32)).to(self.device)

    def _consume_async_events(self) -> bool:
        """Apply a loop closure the worker posted: re-anchor ``last_pose``
        through the reference keyframe's correction, last_pose @
        inv(pose_before) @ pose_now (the synchronous path's ``last_pose =
        kf_pose[kf]``, done late), and drop the stale motion model. Every
        locked entry of tracking calls it first, so a closure is applied
        once, to a pose tracked on the map before it. Returns whether
        ``last_pose`` moved."""
        with self.map.lock:
            ev, self._pending_closure_rebase = self._pending_closure_rebase, None
            if ev is None:
                return False
            ref_kf, ref_seq, pose_before = ev
            self.velocity = None
            m = self.map
            if (
                self.last_pose is None
                or pose_before is None
                or ref_kf < 0
                or not m.kf_valid_host()[ref_kf]
                or int(m.kf_seq[ref_kf]) != ref_seq
            ):
                return False
            rebased = _host(self.last_pose) @ np.linalg.inv(pose_before) @ m.hview("kf_pose")[ref_kf]
            self.last_pose = torch.from_numpy(rebased.astype(np.float32)).to(self.device)
            self._prev_pose = self.last_pose
            return True

    def _reanchor_trajectory(self, kf_id: int, kf_seq: int, kf_pose: np.ndarray):
        """Re-anchor trajectory entries of a keyframe being removed to the
        surviving keyframe nearest in insertion order, keeping the relative
        chain: T_rel' = T_rel @ T_old @ inv(T_new)."""
        survivors = self.map.valid_keyframes_by_seq()
        survivors = survivors[survivors != kf_id]
        if len(survivors) == 0:
            return
        seqs = self.map.kf_seq[survivors]
        new_ref = int(survivors[np.argmin(np.abs(seqs - kf_seq))])
        new_seq = int(self.map.kf_seq[new_ref])
        T_new_inv = np.linalg.inv(self.map.hview("kf_pose")[new_ref])
        out = []
        for entry in self.trajectory:
            fid, ts, pose, ref, T_rel, ref_seq = entry
            if ref == kf_id and ref_seq == kf_seq and T_rel is not None:
                out.append((fid, ts, pose, new_ref, T_rel @ kf_pose @ T_new_inv, new_seq))
            else:
                out.append(entry)
        self.trajectory = out

    def _log_pose(self, pose, timestamp):
        pose_np = _host(pose)
        ref = self.ref_kf
        if ref >= 0:
            T_rel = pose_np @ np.linalg.inv(self.map.hview("kf_pose")[ref])
            ref_seq = int(self.map.kf_seq[ref])
        else:
            T_rel, ref_seq = None, -1
        self.trajectory.append((self.frame_id, timestamp, pose_np, ref, T_rel, ref_seq))
        return pose_np

    # ------------------------------------------------------------------
    # Initialisation
    # ------------------------------------------------------------------
    def _monocular_initialization(self, frame):
        n_kp = int(frame.valid.sum())
        if self._init_frame is None:
            if n_kp > 100:
                self._init_frame = frame
                self._init_frame_id = self.frame_id
                self._prev_matched = frame.xy
            return
        if n_kp <= 100:
            self._init_frame = None
            return

        matches = search_for_initialization(self._init_frame, frame, self._prev_matched)
        m_h = _host(matches)
        if int((m_h >= 0).sum()) < 100:
            self._init_frame = None
            return
        # the next attempt searches around the matched features' current
        # positions
        prev = _host(self._prev_matched).copy()
        sel = m_h >= 0
        prev[sel] = _host(frame.xy)[m_h[sel]]
        self._prev_matched = torch.from_numpy(prev).to(self.device)

        with record_function("init_twoview"):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)  # the same samples on every attempt
            result = initialize_two_view(
                self._init_frame.xy, frame.xy[torch.clamp(matches.long(), min=0)], matches >= 0, self.K,
                generator=gen,
            )
            if not bool(result["success"]):
                return
        self._create_initial_map(frame, m_h, result)

    def _create_initial_map(self, frame, m_h, result):
        """Two keyframes from the initial pair, their landmarks, a global BA,
        and the median-depth scale normalisation."""
        good = _host(result["good_mask"])
        X = _host(result["points3d"])  # frame-1 camera coords == world
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = _host(result["R"])
        T2[:3, 3] = _host(result["t"])

        f1 = self._init_frame
        feat1 = np.nonzero(good)[0]
        ids = self.map.allocate_landmarks(len(feat1))
        feat1 = feat1[: len(ids)]
        feat2 = m_h[feat1]
        obs1 = np.full(f1.n_features, -1, np.int32)
        obs1[feat1] = ids
        obs2 = np.full(frame.n_features, -1, np.int32)
        obs2[feat2] = ids
        kf1 = self.map.add_keyframe(f1, np.eye(4, dtype=np.float32), obs1, self._init_frame_id)
        kf2 = self.map.add_keyframe(frame, T2, obs2, self.frame_id)
        self.map.add_landmarks(
            ids, X[feat1], _host(f1.desc_pm1)[feat1], np.zeros((len(ids), 3), np.float32),
            _host(f1.octave)[feat1], np.zeros(len(ids), np.float32), np.full(len(ids), np.inf, np.float32),
            first_kf=kf1,
        )
        self.mapper.refresh_landmarks(self.map, ids)

        with record_function("init_global_ba"):
            self._initial_global_ba(kf1, kf2, ids)

        Xn = self.map.hview("lm_pos")[ids].copy()
        T2n = self.map.hview("kf_pose")[kf2].copy()
        med = float(np.median(Xn[:, 2]))  # keyframe 1 is the origin: depth = z
        if med <= 0 or (self.map.hview("kf_obs")[kf2] >= 0).sum() < 80:
            self.reset()
            return
        scale = 1.0 / med
        T2n[:3, 3] *= scale
        self.map.set_landmark_positions(ids, Xn * scale)
        self.map.set_kf_poses([kf2], [T2n])
        self.mapper.refresh_landmarks(self.map, ids)

        self.last_pose = torch.from_numpy(T2n).to(self.device)
        self.last_frame = frame
        self.last_obs = obs2
        self.ref_kf = kf2
        self.last_kf_frame_id = self.frame_id
        self.velocity = None
        self.state = TrackingState.OK
        self.new_kf_ids += [kf1, kf2]

    def _initial_global_ba(self, kf1, kf2, ids):
        kf_idx, feat_idx, which = self.map.observations_of(ids)
        obs_uv = self.map.hview("kf_xy")[kf_idx, feat_idx]
        obs_oct = self.map.hview("kf_octave")[kf_idx, feat_idx]
        inv_s2 = _host(self.inv_level_sigma2)[obs_oct.clip(0, self.cfg.n_levels - 1)]
        cams = [kf1, kf2]
        obs_cam = np.where(kf_idx == kf1, 0, 1).astype(np.int64)
        dev = self.device
        prob = BAProblem(
            poses=self.map.kf_pose[torch.tensor(cams, device=dev)],
            points=self.map.lm_pos[torch.from_numpy(ids.astype(np.int64)).to(dev)],
            obs_cam=torch.from_numpy(obs_cam).to(dev),
            obs_point=torch.from_numpy(which.astype(np.int64)).to(dev),
            obs_uv=torch.from_numpy(obs_uv.astype(np.float32)).to(dev),
            obs_inv_sigma2=torch.from_numpy(inv_s2.astype(np.float32)).to(dev),
            obs_mask=torch.ones(len(obs_cam), dtype=torch.bool, device=dev),
            point_obs=torch.from_numpy(build_point_obs(which, len(ids), 4).astype(np.int64)).to(dev),
            fixed_cam=torch.tensor([True, False], device=dev),
            K=self.K,
        )
        poses_new, points_new, _ = bundle_adjustment(prob, iterations=INIT_BA_ITERATIONS)
        self.map.set_kf_poses(cams, _host(poses_new))
        self.map.set_landmark_positions(ids, _host(points_new))

    # ------------------------------------------------------------------
    # Steady-state tracking
    # ------------------------------------------------------------------
    def _track_frame_fused(self, image):
        """The fused step; returns (status, frame, Tcw numpy or None).

        status: 'ok' (tracked), 'stage1' (motion model failed: the caller
        tries the reference keyframe on the returned frame) or 'stage2'
        (local map failed: lost, as in the unfused flow). Its flags, inlier
        count, observations, pose and velocity come back in one
        device-to-host copy, made with the map lock released.
        """
        with self.map.lock:
            # a closure posted before the launch: the step would match the
            # corrected map from a stale prediction
            if self._consume_async_events():
                return "stage1", None, None
            mm = np.unique(self.last_obs[self.last_obs >= 0])
            if len(mm) < 10:
                return "stage1", None, None
            loc = self._local_map_landmarks()
            if len(loc) == 0:
                return "stage1", None, None
            m = self.map
            F = m.f_max
            packed = np.empty(F + LOCAL_MAP_MAX + 2, np.int32)
            packed[:F] = _pad_ids(mm, F)
            packed[F : F + LOCAL_MAP_MAX] = _pad_ids(loc, LOCAL_MAP_MAX)
            packed[F + LOCAL_MAP_MAX] = min(len(mm), F)
            packed[F + LOCAL_MAP_MAX + 1] = min(len(loc), LOCAL_MAP_MAX)
            dev = self.device
            frame, Tcw, obs, vel, ok1, ok, n2 = self.step(
                torch.from_numpy(encode_image(image)).to(dev), torch.from_numpy(packed).to(dev), self.velocity,
                self.last_pose, m.lm_pos, m.lm_desc_pm1, m.lm_valid, m.lm_octave,
                m.lm_normal, m.lm_min_dist, m.lm_max_dist,
            )
            self.n_fused_frames += 1
            flags = torch.stack([ok1.to(torch.int32), ok.to(torch.int32), n2.to(torch.int32)])
            out = torch.cat([
                flags, obs.to(torch.int32),
                Tcw.contiguous().view(torch.int32).reshape(16), vel.contiguous().view(torch.int32).reshape(16),
            ])
        out = out.cpu().numpy()
        n_feat = obs.shape[0]
        ok1_h, ok_h, n2_h = bool(out[0]), bool(out[1]), int(out[2])
        if not ok1_h:
            return "stage1", frame, None
        if not ok_h:
            return "stage2", frame, None
        obs_h = out[3 : 3 + n_feat]
        Tcw_h = out[3 + n_feat : 19 + n_feat].view(np.float32).reshape(4, 4)
        with self.map.lock:
            self._prev_pose = self.last_pose
            self.last_pose = Tcw
            self.last_frame = frame
            self.last_obs = obs_h
            self.velocity = vel
            self.n_inliers = n2_h
            if self._consume_async_events():  # posted while the step ran on the pre-closure map
                Tcw_h = self.last_pose
            if self._need_new_keyframe(frame) and self._insert_keyframe(frame):
                Tcw_h = self.last_pose  # the epoch may have moved the keyframe
        return "ok", frame, Tcw_h

    def _track_frame(self, frame, try_motion: bool = True) -> bool:
        self._consume_async_events()
        ok = False
        if try_motion and self.velocity is not None:
            ok = self._track_with_motion_model(frame)
        if not ok:
            ok = self._track_reference_keyframe(frame)
        if ok:
            ok = self._track_local_map(frame)
        if not ok:
            self.state = TrackingState.LOST
            self.velocity = None
            return False
        if self.last_pose is not None:
            self.velocity = self.last_pose @ torch.linalg.inv_ex(self._prev_pose)[0]
        if self._need_new_keyframe(frame):
            self._insert_keyframe(frame)
        self.last_frame = frame
        return True

    def _gather_landmark_arrays(self, lm_ids: np.ndarray, pad: int, invariants: bool = False):
        ids = _pad_ids(lm_ids, pad)
        m = self.map
        ids_t = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        valid = (torch.arange(pad, device=self.device) < len(lm_ids)) & m.lm_valid[ids_t]
        base = (m.lm_pos[ids_t], m.lm_desc_pm1[ids_t], valid, m.lm_octave[ids_t], ids)
        if not invariants:
            return base
        return base + (m.lm_normal[ids_t], m.lm_min_dist[ids_t], m.lm_max_dist[ids_t])

    def _pose_opt(self, frame, obs: np.ndarray, Tcw_init):
        """Pose-only BA of the frame against its per-feature landmark
        bindings ``obs``; unbinds the outliers in place. Returns (Tcw,
        number of inliers)."""
        obs_t = torch.from_numpy(obs.astype(np.int64)).to(self.device)
        has = obs_t >= 0
        Xw = self.map.lm_pos[torch.clamp(obs_t, min=0)]
        inv_s2 = self.inv_level_sigma2[torch.clamp(frame.octave.long(), 0, self.cfg.n_levels - 1)]
        Tcw, inlier, n_in = pose_optimization(Tcw_init, Xw, frame.xy, inv_s2, has & frame.valid, self.K)
        obs[~_host(inlier)] = -1
        return Tcw, int(n_in)

    def _pose_opt_from_matches(self, frame, lm_ids_padded, matches, Tcw_init):
        m_h = _host(matches)
        sel = m_h >= 0
        obs = np.full(frame.n_features, -1, np.int32)
        obs[m_h[sel]] = lm_ids_padded[: len(m_h)][sel]
        Tcw, n_in = self._pose_opt(frame, obs, Tcw_init)
        return Tcw, obs, n_in

    def _track_with_motion_model(self, frame) -> bool:
        """Project the last frame's landmarks from the constant-velocity
        prediction (radius 15, retried at 30), then pose-only BA."""
        pred = self.velocity @ self.last_pose
        lm_ids = np.unique(self.last_obs[self.last_obs >= 0])
        if len(lm_ids) < 10:
            return False
        pts, desc, valid, octv, ids_pad = self._gather_landmark_arrays(lm_ids, self.map.f_max)
        for radius in (15.0, 30.0):
            matches = search_by_projection(pts, desc, valid, octv, pred, frame, self.K, radius, self.scale_factors)[0]
            n_matches = int((matches >= 0).sum())
            if n_matches >= 20:
                break
        if n_matches < 20:
            return False
        self._prev_pose = self.last_pose
        Tcw, obs, n_in = self._pose_opt_from_matches(frame, ids_pad, matches, pred)
        if n_in < 10:
            return False
        self.last_pose, self.last_obs, self.n_inliers = Tcw, obs, n_in
        return True

    def _track_reference_keyframe(self, frame) -> bool:
        """Match the frame against the reference keyframe's landmark-bearing
        features, then pose-only BA from the last pose."""
        if self.ref_kf < 0:
            return False
        kf = self.ref_kf
        m = self.map
        kf_obs_h = m.kf_obs_host()[kf]
        kf_has_lm = m.kf_feat_valid[kf] & torch.from_numpy(kf_obs_h >= 0).to(self.device)
        matches = _host(search_frame_to_kf(frame, m.kf_xy[kf], m.kf_angle[kf], m.kf_desc_pm1[kf], kf_has_lm))
        if (matches >= 0).sum() < 15:
            return False
        obs = np.full(frame.n_features, -1, np.int32)
        sel = matches >= 0
        obs[sel] = kf_obs_h[matches[sel]]
        self._prev_pose = self.last_pose
        Tcw, n_in = self._pose_opt(frame, obs, self.last_pose)
        if n_in < 10:
            return False
        self.last_pose, self.last_obs, self.n_inliers = Tcw, obs, n_in
        return True

    def _local_map_landmarks(self) -> np.ndarray:
        """The local map: landmarks of the keyframes that see the last
        frame's landmarks and of their top covisible neighbours, at most
        LOCAL_MAP_MAX (the most observed kept, the clip counted)."""
        cur_lms = np.unique(self.last_obs[self.last_obs >= 0])
        if len(cur_lms) == 0:
            return cur_lms
        kf_idx, _, _ = self.map.observations_of(cur_lms)
        k1 = np.unique(kf_idx)
        covis = self.map.covisibility()
        local_kfs = set(int(k) for k in k1)
        for k in list(local_kfs):
            for j in np.argsort(-covis[k])[:3]:
                if covis[k][j] >= 15:
                    local_kfs.add(int(j))
        lms = [self.map.keyframe_landmarks(k) for k in sorted(local_kfs)]
        if not lms:
            return cur_lms
        out = np.unique(np.concatenate(lms))
        if len(out) > LOCAL_MAP_MAX:
            self.n_local_map_truncations += 1
            order = np.argsort(-self.map.lm_obs_count[out], kind="stable")
            out = np.sort(out[order[:LOCAL_MAP_MAX]])
        return out

    def _track_local_map(self, frame) -> bool:
        """Project the local map (radius 4, landmark invariants), then
        pose-only BA; needs >= 30 inliers."""
        lm_ids = self._local_map_landmarks()
        if len(lm_ids) == 0:
            return False
        pts, desc, valid, octv, ids_pad, normal, min_d, max_d = self._gather_landmark_arrays(
            lm_ids, LOCAL_MAP_MAX, invariants=True
        )
        matches = search_by_projection(
            pts, desc, valid, octv, self.last_pose, frame, self.K, 4.0, self.scale_factors,
            pts_normal=normal, pts_min_dist=min_d, pts_max_dist=max_d,
        )[0]
        Tcw, obs, n_in = self._pose_opt_from_matches(frame, ids_pad, matches, self.last_pose)
        if n_in < 30:
            return False
        self.last_pose, self.last_obs, self.n_inliers = Tcw, obs, n_in
        return True

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame) -> bool:
        """ORB-SLAM's monocular keyframe decision, with a long-gap
        fallback and, on young maps, an inlier-decay criterion; none within
        fps frames of a relocalisation while the map holds more than fps
        keyframes. Asynchronous mapping gates it on the worker's queue: none
        when QUEUE_MAX epochs are pending, and with one pending only on the
        inlier criteria."""
        frames_since_kf = self.frame_id - self.last_kf_frame_id
        if frames_since_kf < 1:
            return False
        if (
            self.last_reloc_frame_id >= 0
            and self.frame_id < self.last_reloc_frame_id + int(self.cfg.fps)
            and self.map.n_kf_active() > int(self.cfg.fps)
        ):
            return False
        # tracked landmarks of the reference keyframe with >= min_obs
        # observations; right after initialisation every landmark has 2
        min_obs = 3 if self.map.n_kf_active() > 2 else 2
        ref_obs = self.map.kf_obs_host()[self.ref_kf]
        seen = ref_obs[ref_obs >= 0]
        ref_tracked = int((self.map.lm_obs_count[seen] >= min_obs).sum()) if len(seen) else 0
        c2 = self.n_inliers < 0.9 * ref_tracked and self.n_inliers > 15
        long_gap = frames_since_kf >= max(2, int(self.cfg.fps))
        self._peak_inliers_since_kf = max(self._peak_inliers_since_kf, self.n_inliers)
        decay = (
            ref_tracked < self.n_inliers
            and self.n_inliers < 0.7 * self._peak_inliers_since_kf
            and frames_since_kf >= 2
            and self.n_inliers > 15
        )
        if not (c2 or decay or (long_gap and self.n_inliers >= 30)):
            return False
        if self.async_driver is not None:
            pending = self.async_driver.pending()
            if pending >= self.async_driver.QUEUE_MAX or (pending >= 1 and not (c2 or decay)):
                return False
        return True

    def _insert_keyframe(self, frame) -> bool:
        """Insert the frame as a keyframe (evicting one when the table is
        full), then run its mapping epoch and a loop-closure attempt, or
        queue them for the worker. Returns whether the epoch ran here (and
        may have moved ``last_pose``)."""
        if self.map.keyframe_capacity() < 1:
            # protect the working set: the reference keyframe, its top
            # covisible neighbours and the earliest keyframe (the gauge)
            protect = {self.ref_kf}
            covis = self.map.covisibility()
            if 0 <= self.ref_kf < covis.shape[0]:
                nb = np.argsort(-covis[self.ref_kf])[: self.cfg.local_window]
                protect |= {int(j) for j in nb if covis[self.ref_kf][j] > 0}
            by_seq = self.map.valid_keyframes_by_seq()
            if len(by_seq):
                protect.add(int(by_seq[0]))
            self.map.evict_keyframe(np.asarray(sorted(protect)))
        kf_id = self.map.add_keyframe(frame, self.last_pose, self.last_obs, self.frame_id)
        self.frame_keyframe = True
        self.new_kf_ids.append(kf_id)
        self.ref_kf = kf_id
        self.last_kf_frame_id = self.frame_id
        self._peak_inliers_since_kf = 0
        if self.async_driver is not None:
            self.async_driver.enqueue(self.map, kf_id)
            return False
        self.mapper.process_new_keyframe(self.map, kf_id)
        if self.loop_closer is not None and self.loop_closer.attempt(self.map, kf_id, self.mapper):
            self.velocity = None  # the map's geometry jumped: the motion model is stale
        # local BA or a loop closure may have moved the keyframe; a copy, not
        # a view of the table
        self.last_pose = self.map.kf_pose[kf_id].clone()
        return True

    # ------------------------------------------------------------------
    def _relocalize(self, frame) -> bool:
        with record_function("reloc"):
            ok, Tcw, obs, n_in, kf = relocalize(self, frame)
        if not ok:
            return False
        self.last_pose = torch.from_numpy(Tcw).to(self.device)
        self._prev_pose = self.last_pose
        self.last_frame = frame
        self.last_obs = obs
        self.n_inliers = n_in
        self.velocity = None
        self.ref_kf = kf  # re-anchor to the keyframe it relocalised against
        self.last_reloc_frame_id = self.frame_id
        self.state = TrackingState.OK
        return True


def materialize_trajectory(tracker) -> list:
    """[(frame_id, ts, Tcw or None), ...] with poses re-anchored to the
    current keyframe poses, so BA refines past frames. Queued mapping
    epochs are applied first."""
    if tracker.async_driver is not None:
        tracker.async_driver.drain()
    out = []
    kf_valid = tracker.map.kf_valid_host()
    kf_pose = tracker.map.hview("kf_pose")
    kf_seq = tracker.map.kf_seq
    for frame_id, ts, pose, ref, T_rel, ref_seq in tracker.trajectory:
        anchored = ref >= 0 and T_rel is not None and kf_valid[ref] and kf_seq[ref] == ref_seq
        if pose is None:
            out.append((frame_id, ts, None))
        elif anchored:
            out.append((frame_id, ts, T_rel @ kf_pose[ref]))
        else:
            out.append((frame_id, ts, pose))
    return out
