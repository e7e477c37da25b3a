"""New map points and landmark fusion of one keyframe epoch, plain: frozen
copies of the port's ``LocalMapper.create_new_points`` and
``LocalMapper.fuse_neighbors`` (``slam/local_mapping.py``, synchronous
mapping), with their epipolar matcher (``frontend/matcher.py::
epipolar_match_kf``), projection matcher (``search_by_projection`` in a
radius of 3 pixels) and DLT triangulation (``geometry/triangulate.py``).

Each works its stage out again from a snapshot of the map as the stage
found it (``MapSnapshot``: numpy copies of the host tables) and returns the
stage's decisions: ``create_points`` the new landmarks, as (feature of the
keyframe, neighbour, feature of the neighbour) -> world point, and
``fuse`` the keyframe-observation table after the fusion's new
observations and merges. Matching and triangulation run in ``dtype``
(float64 for the reference); the host logic (neighbour choice, claims,
merges) is the port's numpy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.step import Frame, _min_by_row, _row_keys, hamming_matrix, search_by_projection

N_NEIGHBORS = 5  # covisible neighbours of new-point creation and fusion
TH_LOW = 50  # max Hamming distance of a strict match
TH_HIGH = 100  # max Hamming distance of a match
HISTO_BINS = 30  # rotation-consistency histogram bins
_BIG = 1 << 20


class MapSnapshot(NamedTuple):
    """The map's host tables as a stage found them. ``kf_obs`` (n_kf, F)
    landmark id a keyframe feature observes or -1; ``kf_valid`` (n_kf,);
    ``covis_row`` (n_kf,) the stage's keyframe's shared-landmark counts;
    ``rows`` keyframe slot -> its tables (``pose`` (4, 4), ``xy`` (F, 2),
    ``octave``, ``angle``, ``feat_valid`` (F,), ``desc_pm1`` (F, 256)) for
    the keyframe and the candidates for its neighbours; the landmark tables
    ``lm_pos`` (L, 3), ``lm_valid``, ``lm_desc_pm1`` (L, 256),
    ``lm_octave``, ``lm_obs_count`` (L,)."""

    kf_obs: np.ndarray
    kf_valid: np.ndarray
    covis_row: np.ndarray
    rows: dict
    lm_pos: np.ndarray
    lm_valid: np.ndarray
    lm_desc_pm1: np.ndarray
    lm_octave: np.ndarray
    lm_obs_count: np.ndarray


def neighbour_candidates(covis_row: np.ndarray) -> list:
    """The keyframe slots either stage may take as neighbours: the first
    ``N_NEIGHBORS`` by covisibility, in the port's order."""
    return [int(i) for i in np.argsort(-covis_row)[:N_NEIGHBORS]]


def _keyframe_landmarks(snap: MapSnapshot, kf: int) -> np.ndarray:
    obs = snap.kf_obs[kf]
    ids = obs[obs >= 0]
    return np.unique(ids[snap.lm_valid[ids]])


def _top2_by_row(dist: torch.Tensor):
    n = dist.shape[-1]
    two = torch.topk(_row_keys(dist), 2, dim=-1, largest=False).values
    return two[..., 0] // n, two[..., 0] % n, two[..., 1] // n


def _rotation_consistency(rot_diff: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """Keep matches whose angle difference falls in one of the 3 fullest
    histogram bins, dropping bins under 0.1 of the fullest."""
    two_pi = 2.0 * math.pi
    m = torch.fmod(rot_diff, two_pi)
    m = torch.where((m != 0) & (m < 0), m + two_pi, m)
    bins = torch.clamp((m / two_pi * HISTO_BINS).to(torch.int64), 0, HISTO_BINS - 1)
    hist = torch.zeros(matched.shape[:-1] + (HISTO_BINS,), dtype=torch.int64, device=matched.device)
    hist.scatter_add_(-1, bins, matched.to(torch.int64))
    top3 = torch.topk(hist, 3, dim=-1).values
    keep_bin = (hist[..., :, None] == top3[..., None, :]).any(dim=-1) & (hist > 0.1 * top3[..., :1])
    return matched & torch.gather(keep_bin, -1, bins)


def fundamental(T1: torch.Tensor, T2: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """F12 with x2' F12 x1 = 0 from world-to-camera poses."""
    R21 = T2[:3, :3] @ T1[:3, :3].T
    t = T2[:3, 3] - R21 @ T1[:3, 3]
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    tx = torch.stack([torch.stack([z, -t[2], t[1]]), torch.stack([t[2], z, -t[0]]), torch.stack([-t[1], t[0], z])])
    Kinv = torch.linalg.inv(K)
    return Kinv.T @ tx @ R21 @ Kinv


def epipolar_match(a: dict, b: dict, free1, free2, F12, inv_level_sigma2, max_dist: int) -> torch.Tensor:
    """Epipolar-constrained matching of two keyframes' free features (``a``
    and ``b``: their tables as tensors): within 3.84 sigma^2 of the
    epipolar line, octaves within one, mutually best, under 0.9 of the
    second best and at most ``max_dist`` bits apart, rotation-consistent
    where 50 matches or more support the histogram. Returns (F1,) index
    into ``b``'s features or -1."""
    dist = hamming_matrix(a["desc_pm1"], b["desc_pm1"])
    xy1, xy2 = a["xy"], b["xy"]
    h1 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)
    l2 = h1 @ F12.T
    num = l2[:, None, 0] * xy2[None, :, 0] + l2[:, None, 1] * xy2[None, :, 1] + l2[:, None, 2]
    den = l2[:, 0] ** 2 + l2[:, 1] ** 2
    d2_line = num * num / torch.clamp(den[:, None], min=1e-12)
    n_levels = inv_level_sigma2.shape[0]
    sig2 = 1.0 / inv_level_sigma2[torch.clamp(b["octave"], 0, n_levels - 1)]
    epi_ok = d2_line < 3.84 * sig2[None, :]
    oct_ok = torch.abs(a["octave"][:, None] - b["octave"][None, :]) <= 1
    masked = torch.where(free1[:, None] & free2[None, :] & epi_ok & oct_ok, dist, _BIG)
    d1, j_best, d2 = _top2_by_row(masked)
    ok = (d1 <= max_dist) & (d1.to(torch.float32) < 0.9 * d2.to(torch.float32))
    rows = torch.arange(xy1.shape[0], device=dist.device)
    ok = ok & (_min_by_row(masked.T)[1][j_best] == rows)
    if int(ok.sum()) >= 50:
        ok = _rotation_consistency(a["angle"] - b["angle"][j_best], ok)
    return torch.where(ok, j_best, -1)


def triangulate(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT: the 4x4 system, rows normalised, solved as the eigenvector of
    the smallest eigenvalue of A^T A. P (3, 4); x (N, 2). Returns (N, 3)."""
    rows = [x1[:, 0, None] * P1[2] - P1[0], x1[:, 1, None] * P1[2] - P1[1],
            x2[:, 0, None] * P2[2] - P2[0], x2[:, 1, None] * P2[2] - P2[1]]
    A = torch.stack(rows, dim=-2)
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=1e-12)
    X = torch.linalg.eigh(A.transpose(-1, -2) @ A)[1][..., :, 0]
    w = X[:, 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[:, :3] / w[:, None]


def _gates(Xw, T1, T2, K, xy1, xy2, inv_s2_1):
    """Finite, in front of both cameras, parallax over about 1.1 degrees,
    and reprojected within the 5.991 chi-square gate in both images."""
    def depth_and_err(T, xy):
        pc = Xw @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = K[0, 0] * pc[:, 0] / zs + K[0, 2]
        v = K[1, 1] * pc[:, 1] / zs + K[1, 2]
        return z, (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2

    z1, e1 = depth_and_err(T1, xy1)
    z2, e2 = depth_and_err(T2, xy2)
    r1 = Xw - (-(T1[:3, :3].T @ T1[:3, 3]))
    r2 = Xw - (-(T2[:3, :3].T @ T2[:3, 3]))
    cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=1e-12)
    th2 = 5.991 / torch.clamp(inv_s2_1, min=1e-9)
    return (torch.all(torch.isfinite(Xw), dim=-1) & (z1 > 0) & (z2 > 0) & (cos_par < 0.9998) & (e1 < th2)
            & (e2 < th2))


def _tables(row: dict, dtype, device) -> dict:
    return {"pose": torch.from_numpy(row["pose"]).to(device, dtype), "xy": torch.from_numpy(row["xy"]).to(device, dtype),
            "octave": torch.from_numpy(row["octave"]).to(device, torch.int64),
            "angle": torch.from_numpy(row["angle"]).to(device, dtype),
            "feat_valid": torch.from_numpy(row["feat_valid"]).to(device),
            "desc_pm1": torch.from_numpy(row["desc_pm1"]).to(device)}


def create_points(snap: MapSnapshot, kf_id: int, K: np.ndarray, scale_factor: float, n_levels: int,
                  dtype=torch.float64, device="cpu") -> dict:
    """CreateNewMapPoints for keyframe ``kf_id``: its free features matched
    along the epipolar lines of each covisible neighbour (10 shared
    landmarks or more, a baseline of 1% of the neighbour's median depth or
    more; the strict descriptor threshold under 4%), triangulated and
    gated; the first accepting neighbour, in covisibility order, claims a
    feature. Returns {(feature, neighbour, neighbour's feature): (3,)
    float64 world point}."""
    if not snap.kf_valid[kf_id] or int(snap.kf_valid.sum()) < 2:
        return {}
    row = snap.covis_row
    neighbors = [i for i in neighbour_candidates(row) if row[i] >= 10 and i != kf_id]
    T1h = snap.rows[kf_id]["pose"].astype(np.float64)
    c1 = -T1h[:3, :3].T @ T1h[:3, 3]
    lanes = []
    for nb in neighbors:
        T2h = snap.rows[nb]["pose"].astype(np.float64)
        c2 = -T2h[:3, :3].T @ T2h[:3, 3]
        baseline = float(np.linalg.norm(c1 - c2))
        lms = _keyframe_landmarks(snap, nb)
        z = (snap.lm_pos[lms].astype(np.float64) @ T2h[:3, :3].T + T2h[:3, 3])[:, 2] if len(lms) else np.zeros(0)
        z_med = float(np.median(z[z > 0])) if (z > 0).any() else 0.0
        if z_med <= 0.0 or baseline / z_med < 0.01:
            continue
        lanes.append((nb, TH_HIGH if baseline / z_med > 0.04 else TH_LOW))
    if not lanes:
        return {}
    Kt = torch.from_numpy(np.asarray(K, np.float64)).to(device, dtype)
    inv_s2 = torch.tensor([1.0 / scale_factor ** (2 * i) for i in range(n_levels)], dtype=dtype, device=device)
    a = _tables(snap.rows[kf_id], dtype, device)
    free1_h = snap.rows[kf_id]["feat_valid"] & (snap.kf_obs[kf_id] < 0)
    free1 = torch.from_numpy(free1_h).to(device)
    inv_s2_1 = inv_s2[torch.clamp(a["octave"], 0, n_levels - 1)]
    claimed = ~free1_h
    out = {}
    for nb, th in lanes:
        b = _tables(snap.rows[nb], dtype, device)
        free2 = b["feat_valid"] & torch.from_numpy(snap.kf_obs[nb] < 0).to(device)
        m = epipolar_match(a, b, free1, free2, fundamental(a["pose"], b["pose"], Kt), inv_s2, th)
        xy2 = b["xy"][torch.clamp(m, min=0)]
        Xw = triangulate(Kt @ a["pose"][:3], Kt @ b["pose"][:3], a["xy"], xy2)
        accept = (m >= 0) & _gates(Xw, a["pose"], b["pose"], Kt, a["xy"], xy2, inv_s2_1)
        m_h, acc_h, X_h = m.cpu().numpy(), accept.cpu().numpy(), Xw.double().cpu().numpy()
        nb_free_now = snap.kf_obs[nb, np.maximum(m_h, 0)] < 0
        new = np.nonzero(acc_h & ~claimed & nb_free_now)[0]
        claimed[new] = True
        for f in new:
            out[(int(f), int(nb), int(m_h[f]))] = X_h[f]
    return out


def _replace(obs: np.ndarray, count: np.ndarray, loser: int, winner: int) -> None:
    """Every observation of ``loser`` re-points to ``winner``, or is dropped
    where the keyframe already sees ``winner``."""
    kf_idx, feat_idx = np.nonzero(obs == loser)
    if len(kf_idx):
        drop = (obs == winner).any(axis=1)[kf_idx]
        obs[kf_idx, feat_idx] = np.where(drop, -1, winner)
        count[winner] += int((~drop).sum())


def fuse(snap: MapSnapshot, kf_id: int, K: np.ndarray, scale_factor: float, n_levels: int,
         dtype=torch.float64, device="cpu") -> np.ndarray:
    """SearchAndFuse for keyframe ``kf_id``: its landmarks projected into
    each covisible neighbour (15 shared landmarks or more) and matched in a
    radius of 3 pixels at most ``TH_LOW`` bits; a matched free feature
    gains the observation, a matched feature holding another landmark
    within 5% of viewing depth merges the two (the one with more
    observations wins). Returns the keyframe-observation table after."""
    obs = snap.kf_obs.copy()
    if not snap.kf_valid[kf_id]:
        return obs
    row = snap.covis_row
    neighbors = [i for i in neighbour_candidates(row) if row[i] >= 15 and i != kf_id]
    lm_ids = _keyframe_landmarks(snap, kf_id)
    if len(lm_ids) == 0 or not neighbors:
        return obs
    pad = obs.shape[1]
    ids_pad = np.zeros(pad, np.int64)
    ids_pad[: min(len(lm_ids), pad)] = lm_ids[:pad]
    valid_now = (np.arange(pad) < len(lm_ids)) & snap.lm_valid[ids_pad]
    Kt = torch.from_numpy(np.asarray(K, np.float64)).to(device, dtype)
    sf = torch.tensor([scale_factor**i for i in range(n_levels)], dtype=dtype, device=device)
    ids_t = torch.from_numpy(ids_pad).to(device)
    pts = torch.from_numpy(snap.lm_pos).to(device, dtype)[ids_t]
    desc = torch.from_numpy(snap.lm_desc_pm1).to(device)[ids_t]
    octv = torch.from_numpy(snap.lm_octave).to(device, torch.int64)[ids_t]
    valid = torch.from_numpy(valid_now).to(device)
    count = snap.lm_obs_count.astype(np.int64).copy()
    for nb in neighbors:
        b = _tables(snap.rows[nb], dtype, device)
        frame = Frame(xy=b["xy"], octave=b["octave"], valid=b["feat_valid"], desc_pm1=b["desc_pm1"])
        m_h = search_by_projection(pts, desc, valid, octv, b["pose"], frame, Kt, 3.0, sf,
                                   max_th_dist=TH_LOW)[0].cpu().numpy()
        hit = np.nonzero((m_h >= 0) & valid_now)[0]
        lms, feats = ids_pad[hit], m_h[hit]
        existing = obs[nb, feats]
        free = existing < 0
        obs[nb, feats[free]] = lms[free]
        np.add.at(count, lms[free], 1)
        conf_lm, conf_ex = lms[~free], existing[~free]
        if len(conf_lm):
            T = snap.rows[nb]["pose"].astype(np.float64)
            X_lm, X_ex = snap.lm_pos[conf_lm].astype(np.float64), snap.lm_pos[conf_ex].astype(np.float64)
            depth = (X_ex @ T[:3, :3].T + T[:3, 3])[:, 2]
            agree = np.linalg.norm(X_lm - X_ex, axis=1) < 0.05 * np.maximum(depth, 1e-3)
            for lm, ex, ok in zip(conf_lm, conf_ex, agree):
                lm, ex = int(lm), int(ex)
                if ex == lm or not ok:
                    continue
                if count[ex] >= count[lm]:
                    _replace(obs, count, lm, ex)
                else:
                    _replace(obs, count, ex, lm)
    return obs
