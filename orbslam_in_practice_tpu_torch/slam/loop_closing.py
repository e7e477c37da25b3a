"""Loop closing: place recognition, Sim3 RANSAC and essential-graph correction.

Port of ``orbslam_in_practice_tpu/slam/loop_closing.py``, with the same
constants and host bookkeeping:

- detection: the keyframes' centred global descriptors (host numpy),
  ranked by ``np.argsort``, skipping covisible and temporally close ones;
- verification: descriptor matching of the two keyframes' landmark-bearing
  features, then a Sim3 RANSAC of ``N_HYP`` Horn hypotheses of 3 pairs at
  once, gated by pixel chi2 in both keyframes; on marginal support, up to
  two rounds of Sim3-guided projection matching (mutual best, ties to the
  lower index) grow the pairs and the RANSAC runs again;
- correction: the essential graph (the insertion-order chain, strong
  covisibility edges, the loop edge) optimised over Sim3
  (``optim/pose_graph.py``), landmarks moved with their reference
  keyframe, scale folded back into SE3 poses, then global BA with the loop
  candidate fixed; then ``attempt`` fuses the new keyframe's landmarks
  into the candidate's neighbourhood (SearchAndFuse, which the reference's
  tracker runs after ``attempt``).

The reference draws its RANSAC samples with ``jax.random.choice`` keyed 2
(first round) and 3 + r (growth round r); here they are given
(``sample_idx[round]``) or drawn from a ``torch.Generator`` seeded the same.

Each stage is a span of the closer's record
(``utils/logging.py::StageTimer``): ``lc_detect``, ``lc_sim3``,
``lc_correct`` for the pose graph, landmark correction and fusion,
``lc_global_ba``; ``stage_s`` reads their host seconds back, and
``closures`` records each accepted loop with its stages' ms and the sizes
of its pose graph and global BA. PERF.md's table lists the spans.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam_in_practice_tpu_torch.frontend.matcher import _argmin_by_col, _min_by_row, match_descriptor_sets
from orbslam_in_practice_tpu_torch.geometry.sim3 import horn_sim3
from orbslam_in_practice_tpu_torch.ops.hamming import hamming_matrix
from orbslam_in_practice_tpu_torch.optim.pose_graph import optimize_pose_graph
from orbslam_in_practice_tpu_torch.slam.global_ba import global_bundle_adjustment
from orbslam_in_practice_tpu_torch.slam.initializer import ransac_samples
from orbslam_in_practice_tpu_torch.slam.place_recognition import center as place_center
from orbslam_in_practice_tpu_torch.utils.logging import StageTimer

N_CAND = 3  # candidates verified a keyframe
N_HYP = 512  # Horn hypotheses, one batch
MIN_INLIERS = 20
BOOTSTRAP_INLIERS = 4  # first-round support worth a guided-growth round
PIX_CHI2 = 9.21  # chi2(2) at 99%, per view
GUIDED_RADIUS = 12.0  # pixels
GUIDED_MAX_DIST = 100  # Hamming
STAGES = ("lc_detect", "lc_sim3", "lc_correct", "lc_global_ba")


def _project(p, K):
    z = torch.clamp(p[..., 2], min=1e-6)
    return torch.stack([K[0, 0] * p[..., 0] / z + K[0, 2], K[1, 1] * p[..., 1] / z + K[1, 2]], dim=-1), p[..., 2]


def guided_match(p_src, desc_src, valid_src, s, R, t, xy_dst, desc_dst, cand_dst, K):
    """Sim3-guided projection matching (ORB-SLAM's SearchBySim3): project
    source landmarks (N, 3), in the source camera's frame, into the
    destination keyframe under (s, R, t) and match by descriptor within
    GUIDED_RADIUS pixels at Hamming <= GUIDED_MAX_DIST, mutual best, ties to
    the lower index. Returns (N,) int64 destination feature or -1."""
    uv, z = _project(s * p_src @ R.T + t, K)
    d2 = torch.sum((xy_dst[None, :, :] - uv[:, None, :]) ** 2, dim=-1)
    ham = hamming_matrix(desc_src, desc_dst)
    ok = valid_src[:, None] & cand_dst[None, :] & (z[:, None] > 0) & (d2 < GUIDED_RADIUS**2) & (ham <= GUIDED_MAX_DIST)
    score = torch.where(ok, ham, 1 << 20)
    d1, best = _min_by_row(score)
    mutual = _argmin_by_col(score)[best] == torch.arange(p_src.shape[0], device=p_src.device)
    return torch.where((d1 < 1 << 20) & mutual, best, -1)


def sim3_ransac(pa, pb, uv_a, uv_b, inv_sigma2_a, inv_sigma2_b, valid, K, sample_idx=None, generator=None):
    """Robust similarity pb ~ s R pa + t from N_HYP 3-point Horn hypotheses.

    pa, pb (N, 3): points in the two keyframes' camera frames; inliers have
    pixel chi2 < PIX_CHI2 in both images and positive depth in both. The
    best hypothesis (first on ties) is refitted on its inliers. sample_idx:
    optional (N_HYP, 3) indices, else drawn from ``generator``.

    Returns (s, R, t, inlier mask, n_inliers), on the device.
    """
    if sample_idx is None:
        sample_idx = ransac_samples(valid, generator, N_HYP, 3)
    sample_idx = torch.as_tensor(sample_idx, device=pa.device).long()
    w = torch.zeros((N_HYP, pa.shape[0]), dtype=pa.dtype, device=pa.device).scatter_(1, sample_idx, 1.0)

    def inliers_of(s, R, t):
        pb_hat = s[..., None, None] * pa @ R.transpose(-1, -2) + t[..., None, :]
        pa_hat = (pb - t[..., None, :]) @ R / torch.clamp(s, min=1e-9)[..., None, None]
        uvb_hat, zb = _project(pb_hat, K)
        uva_hat, za = _project(pa_hat, K)
        e_b = torch.sum((uvb_hat - uv_b) ** 2, dim=-1) * inv_sigma2_b
        e_a = torch.sum((uva_hat - uv_a) ** 2, dim=-1) * inv_sigma2_a
        return valid & (e_b < PIX_CHI2) & (e_a < PIX_CHI2) & (zb > 0) & (za > 0)

    ss, Rs, ts = horn_sim3(pa, pb, w=w)
    best = torch.argmax(torch.sum(inliers_of(ss, Rs, ts), dim=-1))
    inl = inliers_of(ss[best], Rs[best], ts[best])
    s, R, t = horn_sim3(pa, pb, w=inl.to(pa.dtype))
    inl = inliers_of(s, R, t)
    return s, R, t, inl, torch.sum(inl)


class LoopCloser:
    """Loop detection, verification and correction at a keyframe. Its
    spans go to ``record`` (its own unless given); ``stage_s`` reads them
    back from the closer's construction on."""

    def __init__(self, config, device: torch.device | str = "cuda", record: StageTimer | None = None):
        self.cfg = config
        self.record = record if record is not None else StageTimer()
        self._since = self.record.snapshot()
        self.device = torch.device(device)
        self.K = config.cam.K(self.device)
        self.inv_level_sigma2 = 1.0 / np.asarray(
            [config.scale_factor ** (2 * i) for i in range(config.n_levels)], np.float32
        )
        self.last_loop_seq = -(10**9)
        self.n_closures = 0
        self.last_closure = None  # (kf_id, cand) of the latest accepted loop
        self.n_attempts = 0  # keyframes that ran detection
        self.closures: list = []  # one dict per accepted loop
        self.last_sizes: dict = {}  # the latest correction's pose graph and global BA sizes

    @property
    def stage_s(self) -> dict:
        return self.record.seconds(STAGES, self._since)

    # ---------------- place recognition ----------------

    def detect_candidates(self, smap, kf_id: int) -> list:
        """Up to N_CAND candidates by centred global-descriptor similarity
        (> 0), skipping the keyframe's covisible neighbours (>= 15 shared),
        invalid ones and those within 10 insertions of it. Needs >= 10
        keyframes."""
        if smap.n_kf_active() < 10:
            return []
        kf_valid = smap.kf_valid_host()[: smap.n_kf]
        g = place_center(smap.hview("kf_gdesc")[: smap.n_kf], kf_valid)
        sims = g @ g[kf_id]
        covis = smap.covisibility()
        neighbors = set(np.nonzero(covis[kf_id] >= 15)[0].tolist()) | {kf_id}
        cur_seq = int(smap.kf_seq[kf_id])
        cands = []
        for j in np.argsort(-sims):
            j = int(j)
            if sims[j] <= 0.0:
                break
            if j in neighbors or not kf_valid[j]:
                continue
            if abs(cur_seq - int(smap.kf_seq[j])) < 10:  # temporal guard
                continue
            cands.append(j)
            if len(cands) >= N_CAND:
                break
        return cands

    # ---------------- geometric verification ----------------

    def _ransac_pairs(self, smap, pairs: np.ndarray, kf_id: int, cand: int, sample_idx, seed: int):
        """The Sim3 RANSAC on (M, 4) rows [lm_cur, lm_cand, feat_cur,
        feat_cand], padded to f_max (doubled until the pairs fit). Returns
        (s, R, t, n_inliers) on the host."""
        lm_pos = smap.hview("lm_pos")
        Ta = smap.hview("kf_pose")[kf_id]
        Tb = smap.hview("kf_pose")[cand]
        f_cur, f_cand = pairs[:, 2], pairs[:, 3]
        n_lv = self.cfg.n_levels
        n_pad = smap.f_max
        while n_pad < len(pairs):
            n_pad *= 2
        m = len(pairs)
        pa = np.zeros((n_pad, 3), np.float32)
        pb = np.zeros((n_pad, 3), np.float32)
        ua = np.zeros((n_pad, 2), np.float32)
        ub = np.zeros((n_pad, 2), np.float32)
        wa = np.ones(n_pad, np.float32)
        wb = np.ones(n_pad, np.float32)
        valid = np.zeros(n_pad, bool)
        pa[:m] = lm_pos[pairs[:, 1]] @ Tb[:3, :3].T + Tb[:3, 3]  # the candidate's view
        pb[:m] = lm_pos[pairs[:, 0]] @ Ta[:3, :3].T + Ta[:3, 3]  # the current keyframe's
        ua[:m] = smap.hview("kf_xy")[cand][f_cand]
        ub[:m] = smap.hview("kf_xy")[kf_id][f_cur]
        wa[:m] = self.inv_level_sigma2[np.clip(smap.hview("kf_octave")[cand][f_cand], 0, n_lv - 1)]
        wb[:m] = self.inv_level_sigma2[np.clip(smap.hview("kf_octave")[kf_id][f_cur], 0, n_lv - 1)]
        valid[:m] = True
        dev = self.device
        gen = None
        if sample_idx is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        s, R, t, _, n_inl = sim3_ransac(
            *(torch.from_numpy(a).to(dev) for a in (pa, pb, ua, ub, wa, wb, valid)), self.K, sample_idx, gen
        )
        return float(s), R.cpu().numpy(), t.cpu().numpy(), int(n_inl)

    def _guided_pairs(self, smap, kf_id: int, cand: int, s, R, t) -> np.ndarray:
        """Sim3-guided landmark matching both ways (candidate -> current
        under (s, R, t), current -> candidate under its inverse). Returns
        (M, 4) rows [lm_cur, lm_cand, feat_cur, feat_cand]."""
        lm_pos = smap.hview("lm_pos")
        lm_desc = smap.hview("lm_desc_pm1")
        fv = smap.hview("kf_feat_valid")
        obs = smap.kf_obs_host()
        F = smap.f_max
        dev = self.device

        def side(src_kf, dst_kf, s_, R_, t_):
            """src_kf's landmarks into dst_kf's landmark-bearing features:
            rows [lm_dst, lm_src, feat_dst, feat_src]."""
            T_src = smap.hview("kf_pose")[src_kf]
            src_feats = np.nonzero((obs[src_kf] >= 0) & fv[src_kf])[0]
            if len(src_feats) == 0:
                return np.zeros((0, 4), np.int64)
            lms = obs[src_kf][src_feats]
            n = min(len(src_feats), F)
            p_src = np.zeros((F, 3), np.float32)
            d_src = np.zeros((F, 256), np.int8)
            v_src = np.zeros(F, bool)
            p_src[:n] = lm_pos[lms[:n]] @ T_src[:3, :3].T + T_src[:3, 3]
            d_src[:n] = lm_desc[lms[:n]]
            v_src[:n] = True
            m = guided_match(
                torch.from_numpy(p_src).to(dev), torch.from_numpy(d_src).to(dev), torch.from_numpy(v_src).to(dev),
                float(np.float32(s_)), torch.from_numpy(np.asarray(R_, np.float32)).to(dev),
                torch.from_numpy(np.asarray(t_, np.float32)).to(dev), smap.kf_xy[dst_kf], smap.kf_desc_pm1[dst_kf],
                torch.from_numpy((obs[dst_kf] >= 0) & fv[dst_kf]).to(dev), self.K,
            ).cpu().numpy()
            hit = np.nonzero(m[:n] >= 0)[0]
            return np.stack([obs[dst_kf][m[hit]], lms[hit], m[hit], src_feats[hit]], axis=1).astype(np.int64)

        fwd = side(cand, kf_id, s, R, t)
        R_inv = np.asarray(R).T
        s_inv = 1.0 / max(float(s), 1e-9)
        bwd = side(kf_id, cand, s_inv, R_inv, -s_inv * R_inv @ np.asarray(t))
        if len(bwd):
            bwd = bwd[:, [1, 0, 3, 2]]  # rows were [lm_cand, lm_cur, feat_cand, feat_cur]
        return np.concatenate([fwd, bwd], axis=0)

    def compute_sim3(self, smap, kf_id: int, cand: int, sample_idx=None):
        """Sim3 from the candidate's camera frame to the current keyframe's
        (ORB-SLAM's Scm): descriptor pairs (ratio 0.9, Hamming <= 100,
        rotation-consistent), RANSAC, and on marginal support (>=
        BOOTSTRAP_INLIERS, < MIN_INLIERS) up to two guided-growth rounds.
        sample_idx: optional sequence of the (N_HYP, 3) samples of the first
        round and of each growth round.

        Returns (ok, s, R (3, 3), t (3,), n_inliers)."""
        obs = smap.kf_obs_host()
        obs_a, obs_b = obs[kf_id], obs[cand]
        dev = self.device
        has_a = torch.from_numpy(obs_a >= 0).to(dev) & smap.kf_feat_valid[kf_id]
        has_b = torch.from_numpy(obs_b >= 0).to(dev) & smap.kf_feat_valid[cand]
        m_h = match_descriptor_sets(
            smap.kf_desc_pm1[kf_id], has_a, smap.kf_desc_pm1[cand], has_b, smap.kf_angle[kf_id], smap.kf_angle[cand]
        ).cpu().numpy()
        sel = np.nonzero(m_h >= 0)[0]
        if len(sel) < MIN_INLIERS:
            return False, None, None, None, 0
        pairs = np.stack([obs_a[sel], obs_b[m_h[sel]], sel, m_h[sel]], axis=1).astype(np.int64)
        pick = (lambda r: None) if sample_idx is None else (lambda r: sample_idx[r])  # noqa: E731
        s, R, t, n_inl = self._ransac_pairs(smap, pairs, kf_id, cand, pick(0), seed=2)
        allp = pairs
        for grow_round in range(2):
            if not (BOOTSTRAP_INLIERS <= n_inl < MIN_INLIERS):
                break
            grown = self._guided_pairs(smap, kf_id, cand, s, R, t)
            if not len(grown):
                break
            allp = np.concatenate([allp, grown], axis=0)
            _, first = np.unique(allp[:, :2], axis=0, return_index=True)  # dedupe (lm_cur, lm_cand)
            allp = allp[np.sort(first)]
            s, R, t, n_inl = self._ransac_pairs(smap, allp, kf_id, cand, pick(1 + grow_round), seed=3 + grow_round)
        if n_inl < MIN_INLIERS:
            return False, None, None, None, n_inl
        return True, s, R, t, n_inl

    # ---------------- correction ----------------

    def close_loop(self, smap, kf_id: int, cand: int, s, R, t):
        """Essential-graph optimisation with the loop edge; write back the
        corrected poses and landmarks; then global BA with the candidate
        fixed."""
        with self.record.stage("lc_correct"):
            kfs = smap.valid_keyframes_by_seq()  # temporal order, safe under slot recycling
            n = len(kfs)
            pos_of = np.full(smap.k_max, -1, np.int64)
            pos_of[kfs] = np.arange(n)
            S = smap.hview("kf_pose")[kfs].astype(np.float32)  # SE3 is Sim3 with s = 1
            S_inv = np.linalg.inv(S)
            chain_i = np.arange(n - 1)
            chain_j = chain_i + 1
            cv = smap.covisibility()[np.ix_(kfs, kfs)]
            cov_i, cov_j = np.nonzero(np.triu(cv >= 50, k=2))
            ei = np.concatenate([chain_i, cov_i, [pos_of[cand]]]).astype(np.int64)
            ej = np.concatenate([chain_j, cov_j, [pos_of[kf_id]]]).astype(np.int64)
            S_loop = np.eye(4, dtype=np.float32)
            S_loop[:3, :3] = s * R
            S_loop[:3, 3] = t
            meas = np.concatenate([S[chain_j] @ S_inv[chain_i], S[cov_j] @ S_inv[cov_i], S_loop[None]]).astype(np.float32)
            # weights grow with covisibility; chain edges floor at 1
            w_chain = np.maximum(cv[chain_i, chain_j].astype(np.float32) / 50.0, 1.0)
            w_cov = cv[cov_i, cov_j].astype(np.float32) / 50.0
            w = np.concatenate([w_chain, w_cov, [5.0]]).astype(np.float32)
            fixed = np.zeros(n, bool)
            fixed[pos_of[cand]] = True  # the older side anchors the graph
            dev = self.device
            S_opt = optimize_pose_graph(*(torch.from_numpy(a).to(dev) for a in (S, ei, ej, meas, w, fixed))).cpu().numpy()

            # landmarks move with their reference keyframe: X' = S_new^-1 S_old X
            lm_first = smap.lm_first_kf
            sel = np.nonzero(smap.lm_valid_host() & (lm_first >= 0) & (pos_of[np.maximum(lm_first, 0)] >= 0))[0]
            if len(sel):
                k_pos = pos_of[lm_first[sel]]
                M = np.linalg.inv(S_opt)[k_pos] @ S[k_pos]
                X = smap.hview("lm_pos")[sel]
                smap.set_landmark_positions(sel, np.einsum("nij,nj->ni", M[:, :3, :3], X) + M[:, :3, 3])
            # poses: the scale folds into the translation, [sR | t] ~ [R | t / s]
            sR = S_opt[:, :3, :3]
            s_k = np.cbrt(np.linalg.det(sR))
            T_new = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
            T_new[:, :3, :3] = sR / s_k[:, None, None]
            T_new[:, :3, 3] = S_opt[:, :3, 3] / s_k[:, None]
            smap.set_kf_poses(kfs, T_new)
        with self.record.stage("lc_global_ba"):
            ba_sizes = global_bundle_adjustment(smap, self.K, self.inv_level_sigma2, fixed_kfs=(cand,))
        self.last_sizes = dict(graph_n=n, graph_e=len(ei), **dict(zip(("ba_cams", "ba_points", "ba_obs"), ba_sizes)))
        self.n_closures += 1
        self.last_loop_seq = int(smap.kf_seq[kf_id])
        self.last_closure = (int(kf_id), int(cand))
        return True

    # ---------------- entry ----------------

    def attempt(self, smap, kf_id: int, mapper) -> bool:
        """Detect, verify and close a loop at keyframe kf_id (at least 10
        insertions after the last closure). A closure is followed by
        fusing, with ``mapper`` (the LocalMapper), the keyframe's landmarks
        into the candidate and its top 4 covisible neighbours (>= 15
        shared), then refreshing the keyframe's landmarks."""
        if int(smap.kf_seq[kf_id]) - self.last_loop_seq < 10:
            return False
        self.n_attempts += 1
        before = self.stage_s
        with self.record.stage("lc_detect"):
            cands = self.detect_candidates(smap, kf_id)
        for cand in cands:
            with self.record.stage("lc_sim3"):
                ok, s, R, t, n_inl = self.compute_sim3(smap, kf_id, cand)
            if not ok:
                continue
            self.close_loop(smap, kf_id, cand, s, R, t)
            with self.record.stage("lc_correct"):
                covis = smap.covisibility()
                nbs = [cand] + [int(j) for j in np.argsort(-covis[cand])[:4] if covis[cand][j] >= 15 and j != kf_id]
                if mapper.fuse_neighbors(smap, kf_id, neighbors=nbs):
                    mapper.refresh_landmarks(smap, smap.keyframe_landmarks(kf_id))
            after = self.stage_s
            self.closures.append({
                "kf": int(kf_id), "frame": int(smap.kf_frame_id[kf_id]), "kf_seq": int(smap.kf_seq[kf_id]),
                "cand": int(cand), "cand_seq": int(smap.kf_seq[cand]), "scale": float(s), "inliers": int(n_inl),
                "ms": {k: (after.get(k, 0.0) - before.get(k, 0.0)) * 1e3 for k in STAGES}, **self.last_sizes,
            })
            return True
        return False
