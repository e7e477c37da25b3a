"""World model: fixed-shape slot-allocated map of keyframes and landmarks.

Port of ``orbslam_in_practice_tpu/slam/map.py`` with the same semantics:

- keyframe table: poses, per-keyframe feature arrays and ``kf_obs`` (feature
  -> landmark id), so covisibility is a matter of shared ids;
- landmark table: position, representative descriptor, normal, distance
  invariants, octave;
- covisibility (shared-landmark counts between keyframes) maintained
  incrementally under every observation mutation, rebuilt wholesale only
  after the tables are replaced (``from_numpy``);
- slot lifecycle: freed keyframe and landmark slots are recycled; landmark
  frees are quarantined until the next keyframe insertion, so an id cached
  by the tracker between frames never re-binds to a new landmark within an
  epoch; ``kf_seq`` numbers keyframes in insertion order and ``lm_uid`` tags
  each landmark allocation;
- ``lock``, an RLock, guards host truth.

Host truth is numpy (``hview(name)``). The tables that device code reads
(the fused tracking step reads the ``lm_*`` tables, local mapping the
keyframe pose, descriptor, octave, keypoint, angle and validity tables)
also live as tensors on the map's device, under the same names as
attributes. Each mutation writes host truth and then copies the rows it
touched into the device tensor (``index_copy_``); a whole table is never
re-uploaded.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.frontend.frame import Frame
from orbslam_in_practice_tpu_torch.slam.place_recognition import GDESC_DIM, global_descriptor

# tables kept on the device as well, by the row they are indexed by
_KF_DEVICE = ("kf_pose", "kf_xy", "kf_octave", "kf_angle", "kf_feat_valid", "kf_desc_pm1")
_LM_DEVICE = ("lm_pos", "lm_valid", "lm_desc_pm1", "lm_normal", "lm_min_dist", "lm_max_dist", "lm_octave")
_HOST_ONLY = ("kf_valid", "kf_obs", "kf_gdesc")
TABLES = _KF_DEVICE + _LM_DEVICE + _HOST_ONLY
DESC_DIM = 256  # an ORB descriptor as +-1 entries, one per bit
_COUNTERS = ("kf_frame_id", "kf_seq", "lm_first_kf", "lm_uid", "lm_obs_count", "lm_found_count", "lm_visible_count")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SlamMap:
    """Slot-allocated map: numpy host truth + device tensors of the tables
    device code reads."""

    def __init__(
        self,
        k_max: int = 256,
        l_max: int = 16384,
        f_max: int = 1024,
        device: torch.device | str = "cpu",
    ):
        self.k_max = k_max
        self.l_max = l_max
        self.f_max = f_max
        self.device = torch.device(device)
        self.lock = threading.RLock()
        self.n_kf = 0  # slot high-water mark (slots [0, n_kf) may be invalid)
        self.n_lm = 0
        self.next_kf_id = 0  # monotonic keyframe sequence number

        self._kf_pose = np.tile(np.eye(4, dtype=np.float32), (k_max, 1, 1))
        self._kf_valid = np.zeros(k_max, bool)
        self.kf_frame_id = np.full(k_max, -1, np.int64)
        self.kf_seq = np.full(k_max, -1, np.int64)
        self._kf_xy = np.zeros((k_max, f_max, 2), np.float32)
        self._kf_octave = np.zeros((k_max, f_max), np.int32)
        self._kf_angle = np.zeros((k_max, f_max), np.float32)
        self._kf_feat_valid = np.zeros((k_max, f_max), bool)
        self._kf_desc_pm1 = np.zeros((k_max, f_max, DESC_DIM), np.int8)
        self._kf_obs = np.full((k_max, f_max), -1, np.int32)
        self._kf_gdesc = np.zeros((k_max, GDESC_DIM), np.float32)

        self._lm_pos = np.zeros((l_max, 3), np.float32)
        self._lm_valid = np.zeros(l_max, bool)
        self._lm_desc_pm1 = np.zeros((l_max, DESC_DIM), np.int8)
        self._lm_normal = np.zeros((l_max, 3), np.float32)
        self._lm_min_dist = np.zeros(l_max, np.float32)
        self._lm_max_dist = np.full(l_max, np.inf, np.float32)
        self._lm_octave = np.zeros(l_max, np.int32)
        self.lm_first_kf = np.full(l_max, -1, np.int32)
        self.lm_uid = np.full(l_max, -1, np.int64)  # allocation generation tag
        self.lm_obs_count = np.zeros(l_max, np.int32)
        self.lm_found_count = np.zeros(l_max, np.int32)
        self.lm_visible_count = np.zeros(l_max, np.int32)
        self._next_lm_uid = 0
        self._kf_free: list = []
        self._lm_free: list = []
        self._lm_free_pending: list = []  # quarantined until the next keyframe
        # _sees[k, l]: keyframe k has a feature bound to landmark l;
        # _covis[i, j] = #{l : _sees[i, l] & _sees[j, l]}, diagonal zero
        self._sees = np.zeros((k_max, l_max), bool)
        self._covis = np.zeros((k_max, k_max), np.int32)
        self._covis_dirty = False
        self._dev = {n: self._to_device(n) for n in _KF_DEVICE + _LM_DEVICE}

    @classmethod
    def from_numpy(cls, tables: dict, device: torch.device | str = "cuda") -> "SlamMap":
        """A map holding another map's state: ``tables`` maps every name of
        ``TABLES`` to its host array, the per-slot counters (kf_frame_id,
        kf_seq, lm_first_kf, lm_uid, lm_obs_count, lm_found_count,
        lm_visible_count) to theirs, n_kf, n_lm, next_kf_id and next_lm_uid
        to ints and kf_free, lm_free, lm_free_pending to sequences of slots.
        Covisibility is rebuilt from the observations."""
        k_max, f_max, _ = np.shape(tables["kf_desc_pm1"])
        l_max = len(tables["lm_pos"])
        smap = cls(k_max, l_max, f_max, device="cpu")
        for n in TABLES:
            setattr(smap, "_" + n, np.array(tables[n], dtype=getattr(smap, "_" + n).dtype))
        for n in _COUNTERS:
            setattr(smap, n, np.array(tables[n], dtype=getattr(smap, n).dtype))
        smap.n_kf, smap.n_lm = int(tables["n_kf"]), int(tables["n_lm"])
        smap.next_kf_id, smap._next_lm_uid = int(tables["next_kf_id"]), int(tables["next_lm_uid"])
        smap._kf_free = [int(i) for i in tables["kf_free"]]
        smap._lm_free = [int(i) for i in tables["lm_free"]]
        smap._lm_free_pending = [int(i) for i in tables["lm_free_pending"]]
        smap._covis_dirty = True
        smap.device = torch.device(device)
        smap._dev = {n: smap._to_device(n) for n in _KF_DEVICE + _LM_DEVICE}
        return smap

    # ---------------- host truth and device rows ----------------

    def hview(self, name: str) -> np.ndarray:
        """The numpy host truth of a table, read-only by contract (mutate
        through the map's methods so the device tensors stay equal)."""
        return getattr(self, "_" + name)

    def _to_device(self, name: str) -> torch.Tensor:
        """A copy of a whole host table on the map's device (never a view of
        host memory, even on the CPU)."""
        return torch.from_numpy(getattr(self, "_" + name)).to(self.device, copy=True)

    def _upload(self, ids, *names: str):
        """Copy rows ``ids`` of host tables ``names`` into their device
        tensors."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if len(ids) == 0:
            return
        idx = torch.from_numpy(ids).to(self.device)
        for n in names:
            self._dev[n].index_copy_(0, idx, torch.from_numpy(getattr(self, "_" + n)[ids]).to(self.device))

    def kf_obs_host(self) -> np.ndarray:
        return self._kf_obs

    def lm_valid_host(self) -> np.ndarray:
        return self._lm_valid

    def kf_valid_host(self) -> np.ndarray:
        return self._kf_valid

    # ---------------- incremental covisibility ----------------

    def _covis_rebuild(self):
        self._sees[:] = False
        n = self.n_kf
        self._covis[:] = 0
        if n:
            obs = self._kf_obs[:n]
            mask = (obs >= 0) & self._kf_valid[:n, None]
            kf_idx, feat_idx = np.nonzero(mask)
            self._sees[kf_idx, obs[kf_idx, feat_idx]] = True
            s = self._sees[:n].astype(np.float32)
            counts = (s @ s.T).astype(np.int32)
            np.fill_diagonal(counts, 0)
            self._covis[:n, :n] = counts
        self._covis_dirty = False

    def _covis_add(self, k: int, lm_ids: np.ndarray):
        """Keyframe k gains first-time observations of lm_ids."""
        if self._covis_dirty:
            return
        new = np.unique(np.asarray(lm_ids, np.int64))
        new = new[~self._sees[k, new]]
        if len(new) == 0:
            return
        n = self.n_kf
        d = self._sees[:n, new].sum(axis=1).astype(np.int32)
        self._covis[k, :n] += d
        self._covis[:n, k] += d
        self._sees[k, new] = True
        self._covis[k, k] = 0

    def _covis_remove(self, k: int, lm_ids: np.ndarray):
        """Keyframe k lost its last binding to each of lm_ids."""
        if self._covis_dirty:
            return
        gone = np.unique(np.asarray(lm_ids, np.int64))
        gone = gone[self._sees[k, gone]]
        if len(gone) == 0:
            return
        self._sees[k, gone] = False
        n = self.n_kf
        d = self._sees[:n, gone].sum(axis=1).astype(np.int32)
        self._covis[k, :n] -= d
        self._covis[:n, k] -= d

    def _covis_scrub(self, kf_idx: np.ndarray, lm_vals: np.ndarray):
        """After observations (kf, landmark) were cleared in _kf_obs: drop the
        sees edges no other feature of the keyframe still binds."""
        if self._covis_dirty or len(kf_idx) == 0:
            return
        for k in np.unique(kf_idx):
            lms = np.unique(lm_vals[kf_idx == k])
            row = self._kf_obs[k]
            present = np.zeros(self.l_max, bool)
            present[row[row >= 0]] = True
            self._covis_remove(int(k), lms[~present[lms]])

    def _covis_erase_landmarks(self, lm_ids: np.ndarray):
        if self._covis_dirty or len(lm_ids) == 0:
            return
        n = self.n_kf
        S = self._sees[:n, lm_ids]
        cols = S.any(axis=0)
        if cols.any():
            Sf = S[:, cols].astype(np.float32)
            delta = (Sf @ Sf.T).astype(np.int32)
            np.fill_diagonal(delta, 0)
            self._covis[:n, :n] -= delta
        self._sees[:, lm_ids] = False

    def _covis_remove_keyframe(self, k: int):
        if self._covis_dirty:
            return
        self._covis[k, :] = 0
        self._covis[:, k] = 0
        self._sees[k, :] = False

    def _covis_replace_landmark(self, loser: int, winner: int):
        """Winner's observer set becomes the union; loser vanishes."""
        if self._covis_dirty:
            return
        n = self.n_kf
        A = self._sees[:n, loser].astype(np.int32)
        B = self._sees[:n, winner].astype(np.int32)
        C = A | B
        delta = np.outer(C, C) - np.outer(A, A) - np.outer(B, B)
        np.fill_diagonal(delta, 0)
        self._covis[:n, :n] += delta
        self._sees[:n, loser] = False
        self._sees[:n, winner] = C.astype(bool)

    # ---------------- counts / capacity ----------------

    def n_kf_active(self) -> int:
        return int(self._kf_valid[: self.n_kf].sum())

    def n_lm_active(self) -> int:
        return int(self._lm_valid[: self.n_lm].sum())

    def keyframe_capacity(self) -> int:
        return (self.k_max - self.n_kf) + len(self._kf_free)

    def landmark_capacity(self) -> int:
        return (self.l_max - self.n_lm) + len(self._lm_free)

    def valid_keyframes_by_seq(self) -> np.ndarray:
        """Valid keyframe slots in insertion order."""
        ids = np.nonzero(self._kf_valid[: self.n_kf])[0]
        return ids[np.argsort(self.kf_seq[ids], kind="stable")]

    # ---------------- keyframes ----------------

    def add_keyframe(self, frame: Frame, Tcw, obs: np.ndarray, frame_id: int) -> int:
        """Insert a frame as a keyframe. obs: (F,) landmark id per feature
        (-1 = none). Returns the keyframe slot."""
        if self._lm_free_pending:  # a new mapping epoch: release quarantine
            self._lm_free.extend(self._lm_free_pending)
            self._lm_free_pending = []
        if self._kf_free:
            k = self._kf_free.pop()
        elif self.n_kf < self.k_max:
            k = self.n_kf
            self.n_kf += 1
        else:
            raise RuntimeError("keyframe table full (k_max); evict first")
        nf = frame.n_features
        if nf > self.f_max:
            raise ValueError(f"frame has {nf} features > map f_max {self.f_max}")

        gdesc = global_descriptor(frame.desc_pm1, frame.valid)
        xy, octave, angle, fvalid, desc, gdesc = (
            _host(t) for t in (frame.xy, frame.octave, frame.angle, frame.valid, frame.desc_pm1, gdesc)
        )
        self._kf_pose[k] = _host(Tcw)
        self._kf_valid[k] = True
        self.kf_frame_id[k] = frame_id
        self.kf_seq[k] = self.next_kf_id
        self._kf_xy[k] = 0.0
        self._kf_xy[k, :nf] = xy
        self._kf_octave[k] = 0
        self._kf_octave[k, :nf] = octave
        self._kf_angle[k] = 0.0
        self._kf_angle[k, :nf] = angle
        self._kf_feat_valid[k] = False
        self._kf_feat_valid[k, :nf] = fvalid
        self._kf_desc_pm1[k] = 0
        self._kf_desc_pm1[k, :nf] = desc
        self._kf_gdesc[k] = gdesc

        obs_row = np.full(self.f_max, -1, np.int32)
        obs_row[:nf] = np.asarray(obs, np.int32)[:nf]
        obs_row[~self._kf_feat_valid[k]] = -1
        self._kf_obs[k] = obs_row
        seen = obs_row[obs_row >= 0]
        np.add.at(self.lm_obs_count, seen, 1)
        self._covis_add(k, seen)
        self.next_kf_id += 1
        self._upload([k], *_KF_DEVICE)
        return k

    def set_kf_poses(self, kf_ids, poses):
        kf_ids = np.asarray(kf_ids)
        self._kf_pose[kf_ids] = _host(poses).astype(np.float32)
        self._upload(kf_ids, "kf_pose")

    # ---------------- landmarks ----------------

    def allocate_landmarks(self, n: int) -> np.ndarray:
        """Up to n slots (recycled first, then fresh), each tagged with a
        fresh uid; truncates silently at capacity."""
        n = min(n, self.landmark_capacity())
        n_recycled = min(n, len(self._lm_free))
        recycled = [self._lm_free.pop() for _ in range(n_recycled)]
        fresh = np.arange(self.n_lm, self.n_lm + n - n_recycled, dtype=np.int32)
        self.n_lm += n - n_recycled
        ids = np.concatenate([np.asarray(recycled, np.int32), fresh])
        self.lm_uid[ids] = np.arange(self._next_lm_uid, self._next_lm_uid + len(ids), dtype=np.int64)
        self._next_lm_uid += len(ids)
        return ids

    def _free_landmark_slots(self, ids: np.ndarray):
        """Quarantine fully dereferenced landmark slots; idempotent (uid -1
        marks a freed slot)."""
        ids = np.unique(np.asarray(ids))
        ids = ids[self.lm_uid[ids] >= 0]
        if len(ids) == 0:
            return
        self.lm_obs_count[ids] = 0
        self.lm_first_kf[ids] = -1
        self.lm_uid[ids] = -1
        self._lm_free_pending.extend(int(i) for i in ids)

    def add_landmarks(
        self, ids, pos, desc_pm1, normal, octave, min_dist, max_dist, first_kf: int, valid_mask=None
    ):
        """Batch landmark insertion."""
        ids = np.asarray(ids)
        self._lm_pos[ids] = _host(pos).astype(np.float32)
        self._lm_desc_pm1[ids] = _host(desc_pm1).astype(np.int8)
        self._lm_normal[ids] = _host(normal).astype(np.float32)
        self._lm_octave[ids] = _host(octave).astype(np.int32)
        self._lm_min_dist[ids] = _host(min_dist).astype(np.float32)
        self._lm_max_dist[ids] = _host(max_dist).astype(np.float32)
        self._lm_valid[ids] = True if valid_mask is None else np.asarray(valid_mask)
        self.lm_first_kf[ids] = first_kf
        self._upload(ids, *_LM_DEVICE)

    def set_landmark_positions(self, ids, pos):
        ids = np.asarray(ids)
        self._lm_pos[ids] = _host(pos).astype(np.float32)
        self._upload(ids, "lm_pos")

    def write_landmark_invariants(self, ids, normal, min_dist, max_dist, desc_pm1, octave, upd):
        """Write refreshed invariants for the rows of ``ids`` where ``upd``."""
        sel = np.asarray(upd)
        ids = np.asarray(ids)[sel]
        if len(ids) == 0:
            return
        self._lm_normal[ids] = np.asarray(normal, np.float32)[sel]
        self._lm_min_dist[ids] = np.asarray(min_dist, np.float32)[sel]
        self._lm_max_dist[ids] = np.asarray(max_dist, np.float32)[sel]
        self._lm_desc_pm1[ids] = np.asarray(desc_pm1, np.int8)[sel]
        self._lm_octave[ids] = np.asarray(octave, np.int32)[sel]
        self._upload(ids, "lm_normal", "lm_min_dist", "lm_max_dist", "lm_desc_pm1", "lm_octave")

    def erase_landmarks(self, ids: np.ndarray):
        """SetBadFlag: invalidate, unbind from every keyframe, recycle."""
        if len(ids) == 0:
            return
        ids = np.asarray(ids)
        self._lm_valid[ids] = False
        is_bad = np.zeros(self.l_max, bool)
        is_bad[ids] = True
        obs_bad = (self._kf_obs >= 0) & is_bad[np.maximum(self._kf_obs, 0)]
        self._kf_obs[obs_bad] = -1
        self._covis_erase_landmarks(ids)
        self._free_landmark_slots(ids)
        self._upload(ids, "lm_valid")

    def evict_landmarks(self, n: int, protect: np.ndarray | None = None) -> int:
        """Erase the n lowest-value valid landmarks (fewest observations,
        then worst found/visible ratio), never a protected one. Returns the
        count."""
        if n <= 0:
            return 0
        valid = self._lm_valid[: self.n_lm].copy()
        if protect is not None and len(protect):
            valid[np.clip(np.asarray(protect, np.int64), 0, self.n_lm - 1)] = False
        cand = np.nonzero(valid)[0]
        if len(cand) == 0:
            return 0
        found_ratio = self.lm_found_count[cand] / np.maximum(self.lm_visible_count[cand], 1)
        order = np.lexsort((found_ratio, self.lm_obs_count[cand]))
        victims = cand[order[:n]]
        self.erase_landmarks(victims.astype(np.int32))
        return len(victims)

    def _gc_orphan_landmarks(self, candidate_ids: np.ndarray):
        """Free landmarks whose observation count dropped to zero."""
        if len(candidate_ids) == 0:
            return
        cand = np.unique(np.asarray(candidate_ids))
        orphan = cand[(self.lm_obs_count[cand] <= 0) & self._lm_valid[cand]]
        if len(orphan) == 0:
            return
        self._lm_valid[orphan] = False
        self._free_landmark_slots(orphan)
        self._upload(orphan, "lm_valid")

    def add_observations(self, kf_id: int, feat_idx: np.ndarray, lm_ids: np.ndarray):
        """Bind landmark ids to keyframe features."""
        if len(feat_idx) == 0:
            return
        self._kf_obs[kf_id, np.asarray(feat_idx)] = np.asarray(lm_ids, np.int32)
        np.add.at(self.lm_obs_count, np.asarray(lm_ids), 1)
        self._covis_add(kf_id, np.asarray(lm_ids))

    # ---------------- queries ----------------

    def covisibility(self) -> np.ndarray:
        """(n_kf, n_kf) shared-landmark counts, a live view (copy before
        mutating)."""
        if self._covis_dirty:
            self._covis_rebuild()
        return self._covis[: self.n_kf, : self.n_kf]

    def keyframe_landmarks(self, kf_id: int) -> np.ndarray:
        """Valid landmark ids a keyframe observes, sorted, deduplicated."""
        obs = self._kf_obs[kf_id]
        ids = obs[obs >= 0]
        return np.unique(ids[self._lm_valid[ids]])

    def observations_of(self, lm_ids: np.ndarray) -> tuple:
        """(kf_idx, feat_idx, index into lm_ids) of every observation of the
        given landmarks."""
        obs = self._kf_obs[: self.n_kf]
        lookup = np.full(self.l_max, -1, np.int64)
        lookup[lm_ids] = np.arange(len(lm_ids))
        hit = (obs >= 0) & (lookup[np.maximum(obs, 0)] >= 0)
        kf_idx, feat_idx = np.nonzero(hit)
        return kf_idx, feat_idx, lookup[obs[kf_idx, feat_idx]]

    def stats(self) -> dict:
        return {
            "n_kf": self.n_kf_active(),
            "n_lm": self.n_lm_active(),
            "n_obs": int((self._kf_obs >= 0).sum()),
            "kf_slots_hw": self.n_kf,
            "lm_slots_hw": self.n_lm,
            "kf_free": len(self._kf_free),
            "lm_free": len(self._lm_free) + len(self._lm_free_pending),
        }

    def remove_keyframe(self, kf_id: int):
        """Drop a keyframe and its observations, recycle the slot, re-anchor
        the landmarks it anchored to their earliest other observer and free
        landmarks left unobserved. ``on_kf_removed(kf_id, seq, pose)``, when
        set, fires first so owners of keyframe-relative state can re-anchor."""
        hook = getattr(self, "on_kf_removed", None)
        if hook is not None:
            hook(int(kf_id), int(self.kf_seq[kf_id]), self._kf_pose[kf_id].copy())
        obs = self._kf_obs[kf_id]
        seen = obs[obs >= 0]
        np.subtract.at(self.lm_obs_count, seen, 1)
        self._kf_valid[kf_id] = False
        self._kf_obs[kf_id] = -1
        self._kf_feat_valid[kf_id] = False
        self._kf_gdesc[kf_id] = 0.0
        self.kf_seq[kf_id] = -1
        self.kf_frame_id[kf_id] = -1
        self._kf_free.append(int(kf_id))
        self._upload([kf_id], "kf_feat_valid")
        self._covis_remove_keyframe(kf_id)
        seen = np.unique(seen)
        anchored = seen[self.lm_first_kf[seen] == kf_id]
        if len(anchored):
            first = np.full(len(anchored), -1, np.int32)
            kf_idx, _, which = self.observations_of(anchored)
            if len(kf_idx):
                # by seq descending, so the last write of a duplicate index
                # leaves the smallest seq
                order = np.argsort(-self.kf_seq[kf_idx], kind="stable")
                first[which[order]] = kf_idx[order].astype(np.int32)
            self.lm_first_kf[anchored] = first
        self._gc_orphan_landmarks(seen)

    def evict_keyframe(self, protect: np.ndarray) -> int:
        """Evict the most redundant unprotected keyframe (the share of its
        landmarks seen by >= 4 keyframes; one without landmarks first), ties
        to the one most covisible with the protected set. Returns the slot
        or -1."""
        valid = self._kf_valid[: self.n_kf].copy()
        protect = set(int(p) for p in protect)
        cands = [k for k in np.nonzero(valid)[0] if int(k) not in protect]
        if not cands:
            return -1
        obs_c = self._kf_obs[np.asarray(cands)]
        has = obs_c >= 0
        well = (self.lm_obs_count[np.maximum(obs_c, 0)] >= 4) & has
        n_has = has.sum(axis=1)
        redundancy = np.where(n_has > 0, well.sum(axis=1) / np.maximum(n_has, 1), 2.0)
        covis = self.covisibility()
        prot = [p for p in protect if p < self.n_kf and valid[p]]
        strength = (
            covis[np.asarray(cands)][:, np.asarray(prot, int)].sum(axis=1) if prot else np.zeros(len(cands))
        )
        order = sorted(range(len(cands)), key=lambda i: (-redundancy[i], -strength[i]))
        victim = int(cands[order[0]])
        self.remove_keyframe(victim)
        return victim

    def replace_landmark(self, loser: int, winner: int):
        """Merge duplicates: every observation of ``loser`` re-points to
        ``winner``, or is dropped where the keyframe already sees it."""
        obs = self._kf_obs
        kf_idx, feat_idx = np.nonzero(obs == loser)
        if len(kf_idx):
            drop = (obs == winner).any(axis=1)[kf_idx]
            obs[kf_idx, feat_idx] = np.where(drop, -1, winner).astype(np.int32)
            self.lm_obs_count[winner] += int((~drop).sum())
        self._covis_replace_landmark(loser, winner)
        self._lm_valid[loser] = False
        self._upload([loser], "lm_valid")
        self._free_landmark_slots(np.asarray([loser]))

    def scrub_observations(self, kf_idx, feat_idx):
        """Remove specific (keyframe, feature) observations; collects
        landmarks left unobserved."""
        if len(kf_idx) == 0:
            return
        kf_idx = np.asarray(kf_idx)
        feat_idx = np.asarray(feat_idx)
        obs = self._kf_obs[kf_idx, feat_idx]
        sel = obs >= 0
        seen = obs[sel]
        np.subtract.at(self.lm_obs_count, seen, 1)
        self._kf_obs[kf_idx, feat_idx] = -1
        self._covis_scrub(kf_idx[sel], seen)
        self._gc_orphan_landmarks(seen)

    def pseudo_frame(self, kf_id: int) -> Frame:
        """A stored keyframe as a Frame of device tensors."""
        d = self._dev
        return Frame(
            xy=d["kf_xy"][kf_id],
            xy_raw=d["kf_xy"][kf_id],
            octave=d["kf_octave"][kf_id],
            angle=d["kf_angle"][kf_id],
            response=torch.zeros(self.f_max, dtype=torch.float32, device=self.device),
            valid=d["kf_feat_valid"][kf_id],
            desc_packed=torch.zeros((self.f_max, 8), dtype=torch.int32, device=self.device),
            desc_pm1=d["kf_desc_pm1"][kf_id],
        )


def _device_table(name: str):
    return property(lambda self: self._dev[name], doc=f"Device tensor of the {name} table.")


for _name in _KF_DEVICE + _LM_DEVICE:
    setattr(SlamMap, _name, _device_table(_name))
