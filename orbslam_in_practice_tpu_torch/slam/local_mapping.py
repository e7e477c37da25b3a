"""Local mapping: one epoch per keyframe, run by the tracker or its worker.

Port of ``orbslam_in_practice_tpu/slam/local_mapping.py``: landmark
invariant refresh (normals, distance ranges, distinctive descriptors), new
points triangulated against the covisible neighbours, fusion of duplicate
landmarks, windowed local BA, and recent-landmark and keyframe culling.

Device work reads the map's device tables, gathering keyframe poses,
features and descriptors by index; the reference's ``jax.vmap`` over
neighbour keyframes is a leading batch dimension of ``NB`` lanes (padding
lanes carry no free features and match nothing). The host bookkeeping is
the reference's numpy, with the same sort orders, so tie order matches.

Every stage that reads the device runs in three parts, as the reference's
do: assemble and queue the device work under ``smap.lock``; wait for the
device and copy the results to the host with the lock released; apply
under the lock, skipping keyframes whose slot no longer holds the same
keyframe (``kf_seq``) and landmarks freed or recycled since (``lm_uid``).
Device work queued under the lock reads the tables before any later
mutation: every thread queues on the same (default) CUDA stream, in lock
order. Local BA copies its problem to the host under the lock and solves it
without the lock.

Each stage of ``process_new_keyframe`` is a span of the mapper's record
(``utils/logging.py::StageTimer``), and so are the three parts of new-point
creation, fusion and local BA; ``stage_s`` reads the stages' host seconds
back, ``n_epochs`` counts the epochs. PERF.md's table lists the spans and
counters and what reads each.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.frontend.frame import Frame
from orbslam_in_practice_tpu_torch.frontend.matcher import (
    TH_HIGH,
    TH_LOW,
    epipolar_match_kf,
    fundamental_from_poses,
    search_by_projection,
)
from orbslam_in_practice_tpu_torch.geometry.triangulate import triangulate_dlt
from orbslam_in_practice_tpu_torch.optim.ba import (
    BAProblem,
    adaptive_o_max,
    build_point_obs,
    bundle_adjustment,
    count_obs_drops,
)
from orbslam_in_practice_tpu_torch.utils.logging import StageTimer

O_MAX = 12  # max observations per landmark used in invariants / local BA
N_NEIGHBORS = 5  # covisible neighbours of new-point creation and fusion
LOCAL_BA_ITERATIONS = 10
STAGES = ("kf_create", "kf_fuse", "kf_local_ba", "kf_cull", "kf_refresh")
_LOG = logging.getLogger("orbslam_tpu_torch")


def _landmark_invariants(lm_pos, kf_pose_tbl, kf_desc_tbl, kf_oct_tbl, obs_kf, obs_feat, obs_valid, scale_factor, n_levels):
    """Normals, distance invariants and distinctive descriptors of L
    landmarks from up to O_MAX observations each, gathered on the device.

    lm_pos (L, 3); the keyframe tables; obs_kf, obs_feat (L, O) int64 and
    obs_valid (L, O) bool. Normal: the mean unit vector from the observing
    camera centres. Distance range from the last observation's octave:
    max = dist * scale^octave, min = max / scale^(n_levels - 1).
    Descriptor: the observation's with the least median Hamming distance to
    the others (the median of an even count is the mean of the middle two).

    Returns (normal (L, 3), min_dist (L,), max_dist (L,), desc (L, 256),
    octave (L,)).
    """
    pose = kf_pose_tbl[obs_kf]  # (L, O, 4, 4)
    obs_desc = kf_desc_tbl[obs_kf, obs_feat]  # (L, O, 256)
    obs_octave = kf_oct_tbl[obs_kf, obs_feat]
    R, t = pose[..., :3, :3], pose[..., :3, 3]
    centers = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    vecs = lm_pos[:, None, :] - centers
    norms = torch.clamp(torch.linalg.vector_norm(vecs, dim=-1, keepdim=True), min=1e-9)
    w = obs_valid[..., None].to(torch.float32)
    normal = torch.sum(vecs / norms * w, dim=1)
    normal = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1, keepdim=True), min=1e-9)

    idx_last = torch.clamp(torch.sum(obs_valid.to(torch.int64), dim=1) - 1, min=0)[:, None]
    dist_ref = torch.gather(norms[..., 0], 1, idx_last)[:, 0]
    oct_ref = torch.gather(obs_octave, 1, idx_last)[:, 0]
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=lm_pos.device)
    max_dist = dist_ref * sf ** oct_ref.to(torch.float32)
    min_dist = max_dist / sf ** (float(n_levels) - 1.0)

    d = obs_desc.to(torch.float32)
    ham = (256.0 - d @ d.transpose(-1, -2)) * 0.5  # (L, O, O)
    pair_ok = obs_valid[:, :, None] & obs_valid[:, None, :]
    srt = torch.sort(torch.where(pair_ok, ham, float("inf")), dim=-1).values
    n_ok = torch.sum(pair_ok, dim=-1, keepdim=True)
    lo = torch.gather(srt, -1, torch.clamp((n_ok - 1) // 2, min=0))[..., 0]
    hi = torch.gather(srt, -1, torch.clamp(n_ok // 2, max=srt.shape[-1] - 1))[..., 0]
    med = torch.where(obs_valid & (n_ok[..., 0] > 0), (lo + hi) * 0.5, float("inf"))
    best = torch.argmin(med, dim=1)
    desc = torch.gather(obs_desc, 1, best[:, None, None].expand(-1, 1, obs_desc.shape[-1]))[:, 0]
    return normal, min_dist, max_dist, desc, oct_ref


def _triangulate_pairs(T1, T2, K, xy1, xy2, pair_valid, inv_sigma2_1):
    """Triangulate matched pairs between keyframe 1 and B neighbours and
    gate them by parallax, cheirality and reprojection.

    T1 (4, 4), T2 (B, 4, 4); xy1 (F, 2), xy2 (B, F, 2); pair_valid (B, F);
    inv_sigma2_1 (F,). Returns (points_world (B, F, 3), accept (B, F)).
    """
    P1 = K @ T1[:3, :4]
    P2 = K @ T2[..., :3, :4]
    Xw = triangulate_dlt(P1, P2[:, None], xy1, xy2)

    def depth_and_reproj(R, t, xy):
        pc = Xw @ R.transpose(-1, -2) + t
        z = pc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
        v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
        return z, (u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2

    z1, e1 = depth_and_reproj(T1[:3, :3], T1[:3, 3], xy1)
    z2, e2 = depth_and_reproj(T2[:, :3, :3], T2[:, None, :3, 3], xy2)
    c1 = -(T1[:3, :3].T @ T1[:3, 3])
    c2 = -(T2[:, :3, :3].transpose(-1, -2) @ T2[:, :3, 3:4])[..., 0]
    r1 = Xw - c1
    r2 = Xw - c2[:, None, :]
    cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=1e-12
    )
    th2 = 5.991 / torch.clamp(inv_sigma2_1, min=1e-9)
    accept = (
        pair_valid
        & torch.all(torch.isfinite(Xw), dim=-1)
        & (z1 > 0)
        & (z2 > 0)
        & (cos_par < 0.9998)
        & (e1 < th2)
        & (e2 < th2)
    )
    return Xw, accept


def _match_triangulate_neighbors(smap, kf_id, free1, nb_idx, nb_free, nb_th, K, inv_level_sigma2):
    """CreateNewMapPoints' epipolar match + triangulation of keyframe
    ``kf_id`` against NB neighbour lanes at once, all keyframe data
    gathered from the map's device tables.

    free1 (F,), nb_free (NB, F) bool on the device; nb_idx (NB,) keyframe
    slots; nb_th (NB,) descriptor thresholds. Returns (matches (NB, F),
    Xw (NB, F, 3), accept (NB, F))."""
    T1 = smap.kf_pose[kf_id]
    xy1 = smap.kf_xy[kf_id]
    oct1 = smap.kf_octave[kf_id]
    nb_T = smap.kf_pose[nb_idx]
    nb_xy = smap.kf_xy[nb_idx]
    F12 = fundamental_from_poses(T1, nb_T, K)
    m = epipolar_match_kf(
        xy1, smap.kf_desc_pm1[kf_id], free1, oct1,
        nb_xy, smap.kf_desc_pm1[nb_idx], nb_free, smap.kf_octave[nb_idx],
        F12, inv_level_sigma2, max_dist=nb_th,
        angle1=smap.kf_angle[kf_id], angle2=smap.kf_angle[nb_idx],
    )
    m_safe = torch.clamp(m.long(), min=0)
    xy2m = torch.gather(nb_xy, 1, m_safe[..., None].expand(-1, -1, 2))
    inv_s2_feat = inv_level_sigma2[torch.clamp(oct1.long(), 0, inv_level_sigma2.shape[0] - 1)]
    Xw, accept = _triangulate_pairs(T1, nb_T, K, xy1, xy2m, m >= 0, inv_s2_feat)
    return m, Xw, accept


def _fuse_match_neighbors(smap, pts, desc, valid, octv, nb_idx, lane_ok, K, scale_factors):
    """ORBmatcher::Fuse's projection matching of one landmark set into NB
    neighbour keyframes at once (radius 3, Hamming <= TH_LOW). Padding
    lanes (``lane_ok`` False) have no valid features. Returns matches
    (NB, M) into each neighbour's features."""
    F = smap.f_max
    nb = len(nb_idx)
    frame = Frame(
        xy=smap.kf_xy[nb_idx],
        xy_raw=smap.kf_xy[nb_idx],
        octave=smap.kf_octave[nb_idx],
        angle=smap.kf_angle[nb_idx],
        response=torch.zeros((nb, F), dtype=torch.float32, device=pts.device),
        valid=smap.kf_feat_valid[nb_idx] & lane_ok[:, None],
        desc_packed=torch.zeros((nb, F, 8), dtype=torch.int32, device=pts.device),
        desc_pm1=smap.kf_desc_pm1[nb_idx],
    )
    m, _, _ = search_by_projection(
        pts, desc, valid, octv, smap.kf_pose[nb_idx], frame, K, 3.0, scale_factors, max_th_dist=TH_LOW
    )
    return m


class LocalMapper:
    """The local-mapping pipeline, run by Tracking after each keyframe
    insertion or by the asynchronous worker (``slam/async_mapping.py``).

    It records its spans and counters in ``record`` (its own unless
    given). ``stage_s`` (stage -> host seconds) and the ``n_*`` totals
    read the record back from the mapper's construction on."""

    def __init__(self, config, device: torch.device | str = "cuda", record: StageTimer | None = None):
        self.cfg = config
        self.device = torch.device(device)
        self.record = record if record is not None else StageTimer()
        self._since = self.record.snapshot()
        self.scale_factors = np.array([config.scale_factor**i for i in range(config.n_levels)], dtype=np.float32)
        inv_s2 = 1.0 / self.scale_factors**2
        self._inv_s2 = inv_s2
        self.K = config.cam.K(self.device)
        self.inv_level_sigma2_t = torch.from_numpy(inv_s2).to(self.device)
        self.scale_factors_t = torch.from_numpy(self.scale_factors).to(self.device)
        # local-BA camera cap and landmark / observation hard caps
        self.ba_k = int(2 ** int(np.ceil(np.log2(max(4, config.local_window + 8)))))
        self.ba_l_cap = max(config.ba_lm_max, config.ba_lm_budget)
        self.ba_o_cap = max(config.ba_obs_max, config.ba_obs_budget)
        # (lm_id, lm_uid, created_at_seq) for culling: the uid guards
        # against slot recycling, the seq (not the slot) measures age
        self._recent_lms: list = []
        self.n_epochs = 0

    @property
    def stage_s(self) -> dict:
        return self.record.seconds(STAGES, self._since)

    @property
    def n_ba_truncations(self) -> int:
        return self.record.counted("ba_truncations", self._since)

    @property
    def n_ba_obs_drops(self) -> int:
        return self.record.counted("ba_obs_dropped", self._since)

    @property
    def n_fuse_merges(self) -> int:
        return self.record.counted("merges", self._since)

    @property
    def n_lm_evictions(self) -> int:
        return self.record.counted("landmarks_evicted", self._since)

    def _device_get(self, *tensors) -> tuple:
        """A stage's results on the host: the wait for the device, made with
        the map lock released."""
        return tuple(t.cpu().numpy() for t in tensors)

    @staticmethod
    def _live_keyframes(smap, seqs: dict) -> set:
        """The slots of ``seqs`` (slot -> kf_seq at dispatch) that still hold
        the same keyframe: neither removed nor reused since."""
        kf_valid = smap.kf_valid_host()
        return {k for k, q in seqs.items() if kf_valid[k] and int(smap.kf_seq[k]) == q}

    # ---------- landmark invariant refresh ----------

    def refresh_landmarks(self, smap, lm_ids: np.ndarray):
        """Recompute normal / distance range / distinctive descriptor of the
        given landmarks from their current observations (landmarks without
        any keep theirs, as do landmarks freed or recycled meanwhile)."""
        if len(lm_ids) == 0:
            return
        lm_ids = np.asarray(lm_ids)
        with smap.lock:
            outs, has_obs, uids = self._refresh_dispatch(smap, lm_ids)
        normal, min_d, max_d, desc, oct_ref = self._device_get(*outs)
        with smap.lock:
            live = has_obs & (smap.lm_uid[lm_ids] == uids)
            smap.write_landmark_invariants(lm_ids, normal, min_d, max_d, desc, oct_ref, live)

    def _refresh_dispatch(self, smap, lm_ids: np.ndarray):
        kf_idx, feat_idx, which = smap.observations_of(lm_ids)
        L = len(lm_ids)
        obs_kf = np.zeros((L, O_MAX), np.int64)
        obs_feat = np.zeros((L, O_MAX), np.int64)
        obs_val = np.zeros((L, O_MAX), bool)
        if len(which):
            # slot = rank of each observation within its landmark group
            order = np.argsort(which, kind="stable")
            sw = which[order]
            group_start = np.zeros(len(sw), np.int64)
            new_grp = np.nonzero(np.r_[True, sw[1:] != sw[:-1]])[0]
            group_start[new_grp] = np.arange(len(sw))[new_grp]
            group_start = np.maximum.accumulate(group_start)
            slot = np.arange(len(sw)) - group_start
            keep = slot < O_MAX
            li, sl = sw[keep], slot[keep]
            obs_kf[li, sl] = kf_idx[order][keep]
            obs_feat[li, sl] = feat_idx[order][keep]
            obs_val[li, sl] = True
        dev = self.device
        outs = _landmark_invariants(
            smap.lm_pos[torch.from_numpy(lm_ids.astype(np.int64)).to(dev)],
            smap.kf_pose, smap.kf_desc_pm1, smap.kf_octave,
            torch.from_numpy(obs_kf).to(dev), torch.from_numpy(obs_feat).to(dev),
            torch.from_numpy(obs_val).to(dev), self.cfg.scale_factor, self.cfg.n_levels,
        )
        return outs, obs_val.any(axis=1), smap.lm_uid[lm_ids].copy()

    # ---------- new map point creation ----------

    def create_new_points(self, smap, kf_id: int) -> int:
        """Triangulate new landmarks between the new keyframe and its top
        covisible neighbours, all neighbours in one batch. The first
        accepting neighbour (in covisibility order) claims a feature."""
        rec = self.record
        with rec.stage("kf_create.dispatch"), smap.lock:
            disp = self._create_dispatch(smap, kf_id)
        if disp is None:
            rec.count("points_created", 0)
            return 0
        outs, lanes, free1, seqs = disp
        with rec.stage("kf_create.wait"):
            m_all, Xw_all, acc_all = self._device_get(*outs)
        with rec.stage("kf_create.apply"), smap.lock:
            n_created = self._create_apply(smap, kf_id, lanes, free1, seqs, m_all, Xw_all, acc_all)
        rec.count("points_created", n_created)
        return n_created

    def _create_dispatch(self, smap, kf_id: int):
        if not smap.kf_valid_host()[kf_id] or smap.n_kf_active() < 2:
            return None
        row = smap.covisibility()[kf_id].copy()
        order = np.argsort(-row)
        neighbors = [int(i) for i in order[:N_NEIGHBORS] if row[i] >= 10 and i != kf_id]
        kf_pose_h = smap.hview("kf_pose")
        obs_all = smap.hview("kf_obs")
        T1 = kf_pose_h[kf_id]
        c1 = -T1[:3, :3].T @ T1[:3, 3]
        lanes = []
        for nb in neighbors:
            T2 = kf_pose_h[nb]
            # baseline gate: skip a neighbour whose baseline is under 1%
            # of its median scene depth (degenerate epipolar geometry)
            c2 = -T2[:3, :3].T @ T2[:3, 3]
            baseline = float(np.linalg.norm(c1 - c2))
            nb_lms = smap.keyframe_landmarks(nb)
            if len(nb_lms):
                pos_nb = smap.hview("lm_pos")[nb_lms]
                z_nb = (pos_nb @ T2[:3, :3].T + T2[:3, 3])[:, 2]
                z_med = float(np.median(z_nb[z_nb > 0])) if (z_nb > 0).any() else 0.0
            else:
                z_med = 0.0
            if z_med <= 0.0 or baseline / z_med < 0.01:
                continue
            # permissive descriptor threshold only where the baseline
            # makes the epipolar constraint selective
            lanes.append((nb, TH_HIGH if baseline / z_med > 0.04 else TH_LOW))
        if not lanes:
            return None

        NB, F = N_NEIGHBORS, smap.f_max
        fv_all = smap.hview("kf_feat_valid")
        free1 = fv_all[kf_id] & (obs_all[kf_id] < 0)
        nb_free = np.zeros((NB, F), bool)
        nb_th = np.full(NB, TH_LOW, np.int64)
        nb_idx = np.zeros(NB, np.int64)  # padding lanes gather row 0, all not free
        for i, (nb, th) in enumerate(lanes):
            nb_free[i] = fv_all[nb] & (obs_all[nb] < 0)
            nb_th[i] = th
            nb_idx[i] = nb
        dev = self.device
        outs = _match_triangulate_neighbors(
            smap, kf_id, torch.from_numpy(free1).to(dev), torch.from_numpy(nb_idx).to(dev),
            torch.from_numpy(nb_free).to(dev), torch.from_numpy(nb_th).to(dev),
            self.K, self.inv_level_sigma2_t,
        )
        seqs = {k: int(smap.kf_seq[k]) for k in [kf_id] + [nb for nb, _ in lanes]}
        return outs, lanes, free1, seqs

    def _create_apply(self, smap, kf_id, lanes, free1, seqs, m_all, Xw_all, acc_all) -> int:
        live = self._live_keyframes(smap, seqs)
        if kf_id not in live:
            return 0
        obs_all = smap.hview("kf_obs")
        oct1 = smap.hview("kf_octave")[kf_id].copy()
        desc_all = smap.hview("kf_desc_pm1")
        n_created = 0
        # freeness from current host truth: tracking may have bound features
        # while the device worked
        claimed = ~(free1 & (obs_all[kf_id] < 0))
        seq = seqs[kf_id]
        for i, (nb, _) in enumerate(lanes):
            if nb not in live:
                continue
            nb_free_now = obs_all[nb, np.maximum(m_all[i], 0)] < 0
            new_feats = np.nonzero(acc_all[i] & ~claimed & nb_free_now)[0]
            if len(new_feats) == 0:
                continue
            ids = smap.allocate_landmarks(len(new_feats))
            if len(ids) < len(new_feats):  # capacity: keep what fits
                new_feats = new_feats[: len(ids)]
                if len(ids) == 0:
                    continue
            claimed[new_feats] = True
            # provisional invariants, refreshed at the end of the epoch
            smap.add_landmarks(
                ids, Xw_all[i][new_feats], desc_all[kf_id][new_feats],
                np.zeros((len(ids), 3), np.float32), oct1[new_feats],
                np.zeros(len(ids), np.float32), np.full(len(ids), np.inf, np.float32),
                first_kf=kf_id,
            )
            smap.add_observations(kf_id, new_feats, ids)
            smap.add_observations(nb, m_all[i][new_feats], ids)
            self._recent_lms.extend((int(i_), int(smap.lm_uid[i_]), seq) for i_ in ids)
            n_created += len(ids)
        return n_created

    # ---------- local BA ----------

    def local_ba(self, smap, kf_id: int):
        """Windowed local BA: the new keyframe + its most covisible
        neighbours are free; other keyframes observing the window's
        landmarks, and the window's oldest keyframe (the gauge), are fixed.
        The problem is copied off the map under the lock and solved without
        it. Writes back the poses of keyframes still in their slots and the
        positions of landmarks not recycled meanwhile, and scrubs outlier
        observations (chi2 > 5.991) whose binding is unchanged."""
        rec = self.record
        with rec.stage("kf_local_ba.dispatch"), smap.lock:
            disp = self._ba_dispatch(smap, kf_id)
        if disp is None:
            return
        arrays, (cams, seqs, lm_ids, lm_uids, kf_idx, feat_idx, which, obs_cam) = disp
        dev = self.device
        with rec.stage("kf_local_ba.solve"):
            prob = BAProblem(
                **{name: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for name, a in arrays.items()}, K=self.K
            )
            poses_new, points_new, chi2 = self._device_get(*bundle_adjustment(prob, iterations=LOCAL_BA_ITERATIONS))
        with rec.stage("kf_local_ba.apply"), smap.lock:
            live = self._live_keyframes(smap, dict(zip(cams, seqs)))
            sel = [i for i, k in enumerate(cams) if k in live]
            if sel:
                smap.set_kf_poses([cams[i] for i in sel], poses_new[sel])
            same = smap.lm_uid[lm_ids] == lm_uids
            smap.set_landmark_positions(lm_ids[same], points_new[same])
            bad = chi2 > 5.991
            if bad.any():
                k, f = kf_idx[bad], feat_idx[bad]
                ok = (
                    smap.kf_valid_host()[k]
                    & (smap.kf_seq[k] == np.asarray(seqs)[obs_cam[bad]])
                    & (smap.kf_obs_host()[k, f] == lm_ids[which[bad]])
                )
                if ok.any():
                    smap.scrub_observations(k[ok], f[ok])

    def _ba_dispatch(self, smap, kf_id: int):
        """The local-BA problem as host arrays, and what the apply checks:
        (cams, their kf_seq, lm_ids, their lm_uid, and per observation its
        keyframe, feature, landmark index and camera slot)."""
        if not smap.kf_valid_host()[kf_id]:
            return None
        covis = smap.covisibility()
        row = covis[kf_id]
        order = np.argsort(-row)
        window = [kf_id] + [int(i) for i in order[: self.cfg.local_window - 1] if row[i] >= 15 and i != kf_id]
        if len(window) < 2:
            return None
        lm_ids = np.unique(np.concatenate([smap.keyframe_landmarks(k) for k in window]))
        if len(lm_ids) == 0:
            return None
        if len(lm_ids) > self.ba_l_cap:
            # hard cap: keep the landmarks with the most observations
            self.record.count("ba_truncations")
            _LOG.warning("local BA landmark hard cap: %d -> %d (kf %d)", len(lm_ids), self.ba_l_cap, kf_id)
            order = np.argsort(-smap.lm_obs_count[lm_ids], kind="stable")
            lm_ids = np.sort(lm_ids[order[: self.ba_l_cap]])
        kf_idx, feat_idx, which = smap.observations_of(lm_ids)
        in_window = np.isin(kf_idx, window)
        fixed_kfs = np.unique(kf_idx[~in_window])
        cams = (list(window) + [int(k) for k in fixed_kfs])[: self.ba_k]
        cam_slot = {k: i for i, k in enumerate(cams)}
        fixed = np.array([k not in window for k in cams])
        oldest = min(window, key=lambda k: smap.kf_seq[k])
        fixed[cam_slot[oldest]] = True
        if not fixed.any() or len(cams) == 1:
            return None
        keep = np.isin(kf_idx, cams)
        kf_idx, feat_idx, which = kf_idx[keep], feat_idx[keep], which[keep]
        if len(kf_idx) == 0:
            return None
        obs_oct = smap.hview("kf_octave")[kf_idx, feat_idx]
        # strongest observations first (window cameras, then covisibility
        # with the new keyframe, then finer octave), so every clip below
        # keeps the strongest edges
        covis_w = covis[kf_id][kf_idx].astype(np.float64)
        covis_w[in_window[keep]] += 1e9
        order = np.lexsort((obs_oct, -covis_w))
        kf_idx, feat_idx, which, obs_oct = kf_idx[order], feat_idx[order], which[order], obs_oct[order]
        if len(kf_idx) > self.ba_o_cap:
            self.record.count("ba_truncations")
            _LOG.warning("local BA observation hard cap: %d -> %d (kf %d)", len(kf_idx), self.ba_o_cap, kf_id)
        n_obs = min(len(kf_idx), self.ba_o_cap)
        kf_idx, feat_idx, which, obs_oct = kf_idx[:n_obs], feat_idx[:n_obs], which[:n_obs], obs_oct[:n_obs]
        obs_cam = np.array([cam_slot[int(k)] for k in kf_idx], np.int64)
        inv_s2 = self._inv_s2[obs_oct.clip(0, len(self.scale_factors) - 1)]
        max_count = int(np.bincount(which, minlength=1).max())
        o_max = adaptive_o_max(max_count, O_MAX, cap=48)
        dropped = count_obs_drops(which, len(lm_ids), o_max)
        sizes = (len(cams), len(lm_ids), n_obs, dropped)
        for name, n in zip(("ba_cams", "ba_points", "ba_obs", "ba_obs_dropped"), sizes):
            self.record.count(name, n)
        if dropped:
            _LOG.warning("local BA dropped %d observations beyond o_max=%d (kf %d)", dropped, o_max, kf_id)
        which = which.astype(np.int64)
        arrays = dict(
            poses=smap.hview("kf_pose")[cams],
            points=smap.hview("lm_pos")[lm_ids],
            obs_cam=obs_cam,
            obs_point=which,
            obs_uv=smap.hview("kf_xy")[kf_idx, feat_idx].astype(np.float32),
            obs_inv_sigma2=inv_s2.astype(np.float32),
            obs_mask=np.ones(n_obs, bool),
            point_obs=build_point_obs(which, len(lm_ids), o_max).astype(np.int64),
            fixed_cam=fixed,
        )
        seqs = [int(smap.kf_seq[k]) for k in cams]
        return arrays, (cams, seqs, lm_ids, smap.lm_uid[lm_ids].copy(), kf_idx, feat_idx, which, obs_cam)

    # ---------- fusion ----------

    def fuse_neighbors(self, smap, kf_id: int, neighbors=None) -> int:
        """Project the keyframe's landmarks into its covisible neighbours:
        matched free features gain an observation; a matched feature holding
        another landmark within 5% of viewing depth of it triggers a merge
        (the landmark with more observations wins). ``neighbors`` overrides
        the covisible set: the loop closer passes the loop candidate's
        neighbourhood, so the revisit's duplicate landmarks merge into the
        corrected originals (SearchAndFuse)."""
        rec = self.record
        with rec.stage("kf_fuse.dispatch"), smap.lock:
            disp = self._fuse_dispatch(smap, kf_id, neighbors)
        if disp is None:
            return 0
        m_dev, neighbors, ids_pad, uids_pad, seqs = disp
        with rec.stage("kf_fuse.wait"):
            (m_all,) = self._device_get(m_dev)
        with rec.stage("kf_fuse.apply"), smap.lock:
            return self._fuse_apply(smap, kf_id, neighbors, ids_pad, uids_pad, seqs, m_all)

    def _fuse_dispatch(self, smap, kf_id: int, neighbors):
        if not smap.kf_valid_host()[kf_id]:
            return None
        if neighbors is None:
            row = smap.covisibility()[kf_id]
            order = np.argsort(-row)
            neighbors = [int(i) for i in order[:N_NEIGHBORS] if row[i] >= 15 and i != kf_id]
        else:
            neighbors = [int(i) for i in neighbors[:N_NEIGHBORS] if i != kf_id]
        lm_ids = smap.keyframe_landmarks(kf_id)
        if len(lm_ids) == 0 or not neighbors:
            return None
        pad = smap.f_max
        ids_pad = np.zeros(pad, np.int64)
        ids_pad[: min(len(lm_ids), pad)] = lm_ids[:pad]
        base_valid = (np.arange(pad) < len(lm_ids)) & smap.hview("lm_valid")[ids_pad]
        nb_idx = np.zeros(N_NEIGHBORS, np.int64)
        nb_idx[: len(neighbors)] = neighbors
        dev = self.device
        ids_t = torch.from_numpy(ids_pad).to(dev)
        m_dev = _fuse_match_neighbors(
            smap, smap.lm_pos[ids_t], smap.lm_desc_pm1[ids_t], torch.from_numpy(base_valid).to(dev),
            smap.lm_octave[ids_t], torch.from_numpy(nb_idx).to(dev),
            torch.arange(N_NEIGHBORS, device=dev) < len(neighbors), self.K, self.scale_factors_t,
        )
        seqs = {k: int(smap.kf_seq[k]) for k in [kf_id] + neighbors}
        return m_dev, neighbors, ids_pad, smap.lm_uid[ids_pad].copy(), seqs

    def _fuse_apply(self, smap, kf_id, neighbors, ids_pad, uids_pad, seqs, m_all) -> int:
        live = self._live_keyframes(smap, seqs)
        if kf_id not in live:
            return 0
        kf_pose_h = smap.hview("kf_pose")
        # a landmark freed or recycled while the device worked takes no
        # match results
        lm_valid_now = smap.lm_valid_host()[ids_pad] & (smap.lm_uid[ids_pad] == uids_pad)
        n_obs = n_merges = 0
        for i, nb in enumerate(neighbors):
            if nb not in live:
                continue
            m_h = m_all[i]
            obs_b = smap.hview("kf_obs")[nb]
            hit = np.nonzero((m_h >= 0) & lm_valid_now)[0]
            lms = ids_pad[hit]
            feats = m_h[hit]
            existing = obs_b[feats]
            free = existing < 0
            if free.any():
                smap.add_observations(nb, feats[free], lms[free])
                n_obs += int(free.sum())
            # merge only true duplicates: the two points agree within 5%
            # of viewing depth
            conf_lm = lms[~free]
            conf_ex = existing[~free]
            if len(conf_lm):
                lm_pos_live = smap.hview("lm_pos")
                T_nb = kf_pose_h[nb]
                X_lm = lm_pos_live[conf_lm]
                X_ex = lm_pos_live[conf_ex]
                depth = (X_ex @ T_nb[:3, :3].T + T_nb[:3, 3])[:, 2]
                agree = np.linalg.norm(X_lm - X_ex, axis=1) < 0.05 * np.maximum(depth, 1e-3)
                for lm, ex, ok_ in zip(conf_lm, conf_ex, agree):
                    lm, ex = int(lm), int(ex)
                    if ex == lm or not ok_:
                        continue
                    if smap.lm_obs_count[ex] >= smap.lm_obs_count[lm]:
                        smap.replace_landmark(lm, ex)
                    else:
                        smap.replace_landmark(ex, lm)
                    n_merges += 1
        self.record.count("obs_fused", n_obs)
        self.record.count("merges", n_merges)
        return n_obs + n_merges

    # ---------- culling ----------

    def cull_landmarks(self, smap, current_kf: int) -> int:
        """A landmark must be observed by >= 3 keyframes within 2 keyframes
        (by seq) of its creation or it is erased; entries whose slot was
        recycled or already erased are dropped."""
        with smap.lock:
            cur_seq = int(smap.kf_seq[current_kf])
            lm_valid = smap.lm_valid_host()
            keep, erase = [], []
            for lm_id, uid, created_seq in self._recent_lms:
                if smap.lm_uid[lm_id] != uid or not lm_valid[lm_id]:
                    continue
                if cur_seq - created_seq >= 2:
                    if smap.lm_obs_count[lm_id] < 3:
                        erase.append(lm_id)
                else:
                    keep.append((lm_id, uid, created_seq))
            self._recent_lms = keep
            if erase:
                smap.erase_landmarks(np.array(erase, np.int32))
        self.record.count("landmarks_culled", len(erase))
        return len(erase)

    def cull_keyframes(self, smap, kf_id: int) -> int:
        """Remove a covisible keyframe when > 90% of its landmarks are seen
        by >= 3 other keyframes at the same or a finer octave; the two
        initial keyframes (by seq) are exempt, and so are keyframes inserted
        after ``kf_id``: with asynchronous mapping those still wait for
        their own epoch (in ORB-SLAM they are not in the graph yet)."""
        with smap.lock:
            covis = smap.covisibility()
            cur_seq = int(smap.kf_seq[kf_id])
            candidates = [
                int(j) for j in np.nonzero(covis[kf_id] >= 15)[0] if 2 <= smap.kf_seq[j] < cur_seq and j != kf_id
            ]
            if not candidates:
                self.record.count("keyframes_culled", 0)
                return 0
            obs_all = smap.hview("kf_obs")[: smap.n_kf].copy()
            oct_all = smap.hview("kf_octave")[: smap.n_kf]
            valid_kf = smap.hview("kf_valid")[: smap.n_kf].copy()
            n_levels = self.cfg.n_levels
            # per-(landmark, octave) observation histogram, cumulative over
            # octaves, decremented as keyframes are culled
            sel = valid_kf[:, None] & (obs_all >= 0)
            hist = np.zeros((smap.l_max, n_levels), np.int32)
            np.add.at(hist, (obs_all[sel], np.clip(oct_all[sel], 0, n_levels - 1)), 1)
            cum = np.cumsum(hist, axis=1)
            n_culled = 0
            for k in candidates:
                if not valid_kf[k]:
                    continue
                feats = np.nonzero(obs_all[k] >= 0)[0]
                if len(feats) < 20:
                    continue
                lms = obs_all[k, feats]
                octs = np.clip(oct_all[k, feats] + 1, 0, n_levels - 1)
                n_better = cum[lms, octs] - 1  # minus this keyframe's own
                if int((n_better >= 3).sum()) > 0.9 * len(feats):
                    smap.remove_keyframe(k)
                    rm_oct = np.clip(oct_all[k, feats], 0, n_levels - 1)
                    for lvl in range(n_levels):
                        np.subtract.at(cum[:, lvl], lms[rm_oct <= lvl], 1)
                    valid_kf[k] = False
                    obs_all[k] = -1
                    n_culled += 1
        self.record.count("keyframes_culled", n_culled)
        return n_culled

    def stats(self) -> dict:
        return {
            "n_ba_truncations": self.n_ba_truncations,
            "n_ba_obs_drops": self.n_ba_obs_drops,
            "n_fuse_merges": self.n_fuse_merges,
            "n_lm_evictions": self.n_lm_evictions,
            "n_recent_lms": len(self._recent_lms),
        }

    # ---------- entry point ----------

    def process_new_keyframe(self, smap, kf_id: int, kf_seq: int | None = None) -> bool:
        """One keyframe epoch: cull recent landmarks, make room in the
        landmark table, create new points, fuse, local BA, cull keyframes,
        and refresh the keyframe's landmark invariants once at the end.

        Each stage takes the map lock for its own assembly and apply only.
        ``kf_seq``, the keyframe's insertion number when it was queued: an
        epoch whose keyframe was removed (or its slot reused) while it
        waited in the queue does nothing and returns False."""
        with smap.lock:
            if not smap.kf_valid_host()[kf_id] or (kf_seq is not None and int(smap.kf_seq[kf_id]) != kf_seq):
                return False
        self.n_epochs += 1
        rec = self.record
        with rec.stage("kf_cull"):
            self.cull_landmarks(smap, kf_id)
            with smap.lock:
                # landmark-table pressure: evict the weakest old landmarks,
                # never those of the covisible window or the recent ones
                cap = smap.landmark_capacity()
                headroom = min(2048, smap.l_max // 8)
                if cap < headroom:
                    covis_row = smap.covisibility()[kf_id]
                    window = [kf_id] + [
                        int(j)
                        for j in np.argsort(-covis_row)[: self.cfg.local_window]
                        if covis_row[j] >= 15 and j != kf_id
                    ]
                    protect = np.concatenate(
                        [smap.keyframe_landmarks(k) for k in window]
                        + [np.array([i for i, _, _ in self._recent_lms], np.int64)]
                    )
                    rec.count("landmarks_evicted", smap.evict_landmarks(headroom - cap, protect))
        with rec.stage("kf_create"):
            self.create_new_points(smap, kf_id)
        with rec.stage("kf_fuse"):
            self.fuse_neighbors(smap, kf_id)
        with rec.stage("kf_local_ba"):
            with smap.lock:
                n_active = smap.n_kf_active()
            if n_active >= 3:
                self.local_ba(smap, kf_id)
        with rec.stage("kf_cull"):
            with smap.lock:
                n_active = smap.n_kf_active()
            if n_active >= 8:
                self.cull_keyframes(smap, kf_id)
        with rec.stage("kf_refresh"):
            with smap.lock:
                kf_lms = smap.keyframe_landmarks(kf_id) if smap.kf_valid_host()[kf_id] else np.zeros(0, np.int64)
            self.refresh_landmarks(smap, kf_lms)
        return True
