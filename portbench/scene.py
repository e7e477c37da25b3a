"""The benchmark's rendered scenes: a frozen copy of the port's synthetic
renderer, and the same renderer on the card.

``SyntheticSequence`` and ``make_trajectory`` copy
``orbslam_in_practice_tpu_torch/io/synthetic.py`` as it stood when the
benchmark was written, in numpy alone (the port's trajectory rotations came
from its torch ``exp_so3``; here a closed-form rotation about y). Changes
from the copy: the camera takes a principal point (``cx``, ``cy``; the port
centres it) and the lens warp uses it; two trajectories are added:

- ``tum_xyz``: a handheld hover that moves along x, then y, then z, one
  full sine period an axis, with a slow yaw and pitch sway; scaled so its
  mean speeds are the ``trans_speed`` (m a frame) and ``rot_speed`` (rad a
  frame) given;
- ``kitti_loop`` is the port's corridor circuit, unchanged.

``TorchRenderer`` renders the same frames on a device: the quads' z-buffer
over 16x16 pixel tiles of each quad's bounding box, resolved by one
scatter-min over (depth, quad index) keys, which keeps the nearest quad and,
among equal depths, the lowest index, as the copy's in-order overwrite
does. The noise and exposure draws stay on the host, from the copy's own
per-frame generator, so both give the same frames to rounding.

Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np

TILE = 16  # the torch renderer's pixel tile edge


def _yaw_rotation(yaw: float) -> np.ndarray:
    """(3, 3) float32 rotation about the y axis."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


def _rotation(w: np.ndarray) -> np.ndarray:
    """(3, 3) float32 rotation of the axis-angle ``w`` (Rodrigues)."""
    theta = float(np.linalg.norm(w))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = np.asarray(w, np.float64) / theta
    Kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return (np.eye(3) + np.sin(theta) * Kx + (1.0 - np.cos(theta)) * (Kx @ Kx)).astype(np.float32)


def hover_trajectory(n_frames: int, trans_speed: float, rot_speed: float, axis_period: int,
                     yaw_period: int, pitch_period: int) -> np.ndarray:
    """(n, 4, 4) Tcw of the ``tum_xyz`` hover: the camera centre moves
    along x, y and z in turn, one sine period of ``axis_period`` frames an
    axis, and the camera sways in yaw and pitch; amplitudes are scaled so
    the mean distance a frame is ``trans_speed`` and the mean rotation
    angle a frame (between consecutive orientations) is ``rot_speed``."""
    i = np.arange(n_frames, dtype=np.float64)
    axis = (i // axis_period).astype(np.int64) % 3
    s = np.sin(2.0 * np.pi * (i % axis_period) / axis_period)
    pos = np.zeros((n_frames, 3))
    pos[np.arange(n_frames), axis] = s
    step = np.linalg.norm(np.diff(pos, axis=0), axis=-1).mean()
    pos *= trans_speed / step
    ang = np.stack([np.sin(2.0 * np.pi * i / pitch_period), np.sin(2.0 * np.pi * i / yaw_period + 1.0),
                    np.zeros(n_frames)], -1)

    def rot_step(scale):
        Rs = [_rotation(a * scale).astype(np.float64) for a in ang]
        d = [np.arccos(np.clip((np.trace(Rs[k].T @ Rs[k + 1]) - 1.0) / 2.0, -1.0, 1.0)) for k in range(n_frames - 1)]
        return float(np.mean(d)), Rs

    # the mean angle a frame is nearly linear in the amplitude: two fixed
    # secant steps make it exact to rounding
    scale = 1.0
    for _ in range(3):
        mean, _ = rot_step(scale)
        scale *= rot_speed / mean
    _, Rs = rot_step(scale)
    poses = []
    for k in range(n_frames):
        T = np.eye(4, dtype=np.float32)
        R_wc = Rs[k].astype(np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ pos[k].astype(np.float32)
        poses.append(T)
    return np.stack(poses)


def make_trajectory(
    n_frames: int,
    kind: str = "strafe",
    step: float = 0.04,
    orbit_step: float | None = None,
):
    """Ground-truth Tcw per frame: the port's kinds (strafe, forward,
    orbit, rotation, kitti, kitti_loop), copied unchanged."""
    if kind in ("kitti", "kitti_loop"):
        # forward motion punctuated by smooth 90-degree yaw arcs; kitti
        # alternates the turn signs, kitti_loop turns the same way each
        # time (a closed block circuit)
        straight, turn_len = 90, 36
        yaw_rate = np.zeros(n_frames, np.float64)
        period = straight + turn_len
        for s in range(n_frames // period + 1):
            a = s * period + straight
            b = min(a + turn_len, n_frames)
            if a < n_frames:
                sign = 1.0 if (kind == "kitti_loop" or s % 2 == 0) else -1.0
                yaw_rate[a:b] = sign * (np.pi / 2) / turn_len
        psi = np.concatenate([[0.0], np.cumsum(yaw_rate)])[:-1]
        dirs = np.stack([np.sin(psi), np.zeros_like(psi), np.cos(psi)], -1)
        perp = np.stack([np.cos(psi), np.zeros_like(psi), -np.sin(psi)], -1)
        sway = 0.08 * np.sin(np.arange(n_frames) * 0.22)
        pos = np.concatenate(
            [np.zeros((1, 3)), np.cumsum(step * dirs, axis=0)[:-1]]
        )
        pos = pos + sway[:, None] * perp
        pos[:, 1] = 0.015 * np.sin(np.arange(n_frames) * 0.13)  # road bumps
        poses = []
        for i in range(n_frames):
            T = np.eye(4, dtype=np.float32)
            R_wc = _yaw_rotation(float(psi[i]))
            T[:3, :3] = R_wc.T
            T[:3, 3] = -R_wc.T @ pos[i].astype(np.float32)
            poses.append(T)
        return np.stack(poses)
    poses = []
    for i in range(n_frames):
        T = np.eye(4, dtype=np.float32)
        if kind == "strafe":
            t_wc = np.array([i * step, 0.02 * np.sin(i * 0.2), 0.0])
            yaw = 0.01 * np.sin(i * 0.15)
        elif kind == "forward":
            t_wc = np.array([0.15 * np.sin(i * 0.08), 0.0, i * step])
            yaw = 0.02 * np.sin(i * 0.1)
        elif kind == "orbit":
            ang = i * (orbit_step if orbit_step is not None else step * 0.2)
            t_wc = np.array([3.0 * np.sin(ang), 0.0, 3.0 * (1 - np.cos(ang))])
            yaw = np.pi - ang
        elif kind == "rotation":
            t_wc = np.array([i * step * 0.5, 0.0, 0.0])
            yaw = 0.35 * np.sin(i * 0.08)
        else:
            raise ValueError(kind)
        R_wc = _yaw_rotation(yaw)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ t_wc
        poses.append(T)
    return np.stack(poses)


def _separable_gaussian(img: np.ndarray, sigma: float) -> np.ndarray:
    """Small separable Gaussian via shifted-slice sums (no scipy)."""
    r = int(np.ceil(2.5 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(img, ((r, r), (0, 0)), mode="edge")
    out = np.zeros_like(img)
    for i, w in enumerate(k):
        out += w * pad[i : i + img.shape[0], :]
    pad = np.pad(out, ((0, 0), (r, r)), mode="edge")
    out2 = np.zeros_like(img)
    for i, w in enumerate(k):
        out2 += w * pad[:, i : i + img.shape[1]]
    return out2


class SyntheticSequence:
    """Renderable scene: world quads with intensity, size and texture."""

    def __init__(
        self,
        n_frames: int = 60,
        n_points: int = 600,
        width: int = 640,
        height: int = 480,
        fx: float = 500.0,
        fy: float = 500.0,
        kind: str = "strafe",
        seed: int = 0,
        depth_range: tuple = (3.0, 9.0),
        spread: tuple = (6.0, 4.5),
        orbit_step: float | None = None,
        step: float = 0.04,
        noise_sigma: float = 0.0,
        brightness_jitter: float = 0.0,
        texture: float = 0.45,
        psf_sigma: float = 0.8,
        size_range: tuple = (0.06, 0.30),
        dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0),
        cx: float | None = None,
        cy: float | None = None,
        poses: np.ndarray | None = None,
        noise_seed: int | None = None,
    ):
        """As the port's, with the principal point ``cx``, ``cy`` (default
        the image centre), ``poses``, a given (n_frames, 4, 4) trajectory
        in place of ``kind``'s (the scene is still laid out by ``kind``),
        and ``noise_seed``, the seed of the frames' exposure and noise
        draws (default ``seed``, which lays out the world)."""
        rng = np.random.default_rng(seed)
        self.width, self.height = width, height
        self.seed = seed if noise_seed is None else noise_seed
        self.noise_sigma = noise_sigma
        self.brightness_jitter = brightness_jitter
        self.psf_sigma = psf_sigma
        cx = width / 2.0 if cx is None else float(cx)
        cy = height / 2.0 if cy is None else float(cy)
        # radial-tangential lens: for each distorted output pixel the ideal
        # source pixel, by the fixed-point iteration of undistort_points
        self.dist = tuple(float(d) for d in dist)
        self._warp = None
        if any(abs(d) > 1e-12 for d in self.dist):
            cx_, cy_ = cx, cy
            us, vs = np.meshgrid(
                np.arange(width, dtype=np.float32),
                np.arange(height, dtype=np.float32),
            )
            x_d = (us - cx_) / fx
            y_d = (vs - cy_) / fy
            k1, k2, p1, p2, k3 = self.dist
            x, y = x_d.copy(), y_d.copy()
            for _ in range(10):
                r2 = x * x + y * y
                radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
                dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
                dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
                x = (x_d - dx) / radial
                y = (y_d - dy) / radial
            self._warp = (fx * x + cx_, fy * y + cy_)
        self.texture = texture
        self.K = np.array(
            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32
        )
        if poses is None:
            poses = make_trajectory(n_frames, kind, step=step, orbit_step=orbit_step)
        self.poses = np.asarray(poses, np.float32)
        self.n_frames = n_frames
        centers_w = np.stack(
            [-(T[:3, :3].T @ T[:3, 3]) for T in self.poses]
        )
        lo = centers_w.min(axis=0)
        hi = centers_w.max(axis=0)
        if kind == "orbit":
            r_orb = 3.0
            phi = rng.uniform(0, 2 * np.pi, n_points)
            rad = r_orb + rng.uniform(depth_range[0], depth_range[1], n_points)
            yy = rng.uniform(-spread[1], spread[1], n_points)
            self.pts = np.stack(
                [rad * np.sin(phi), yy, r_orb - rad * np.cos(phi)],
                axis=-1,
            ).astype(np.float32)
        elif kind in ("kitti", "kitti_loop"):
            # corridor: facade quads on both sides of the driven path
            station = rng.integers(0, max(n_frames - 1, 1), n_points)
            d = centers_w[np.minimum(station + 1, n_frames - 1)] - centers_w[station]
            nrm = np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
            d = d / nrm
            perp = np.stack([d[:, 2], np.zeros(n_points), -d[:, 0]], -1)
            side = np.where(rng.uniform(size=n_points) < 0.5, -1.0, 1.0)
            lat = rng.uniform(depth_range[0], depth_range[1], n_points)
            h = rng.uniform(-spread[1], spread[1], n_points)
            fwd = rng.uniform(0.0, 6.0, n_points)
            self.pts = (
                centers_w[station]
                + (side * lat)[:, None] * perp
                + d * fwd[:, None]
            ).astype(np.float32)
            self.pts[:, 1] = h
            # corner structure: quads ahead along the mid-turn direction
            dirs_f = centers_w[1:] - centers_w[:-1]
            dirs_f = np.concatenate([dirs_f, dirs_f[-1:]], axis=0)
            dirs_f = dirs_f / np.maximum(
                np.linalg.norm(dirs_f, axis=-1, keepdims=True), 1e-6
            )
            look = 22
            ahead = np.minimum(np.arange(n_frames) + look, n_frames - 1)
            cos_turn = np.sum(dirs_f * dirs_f[ahead], axis=-1)
            turny = cos_turn < np.cos(0.25)
            frontal = turny[station] & (rng.uniform(size=n_points) < 0.3)
            if frontal.any():
                mid = dirs_f[station] + dirs_f[ahead[station]]
                mid = mid / np.maximum(
                    np.linalg.norm(mid, axis=-1, keepdims=True), 1e-6
                )
                dist_f = rng.uniform(
                    depth_range[0], depth_range[1], n_points
                )
                jit = rng.uniform(-3.0, 3.0, n_points)
                p_f = (
                    centers_w[station]
                    + mid * dist_f[:, None]
                    + np.stack(
                        [mid[:, 2], np.zeros(n_points), -mid[:, 0]], -1
                    )
                    * jit[:, None]
                )
                self.pts[frontal] = p_f[frontal].astype(np.float32)
                self.pts[:, 1] = h
            # path clearance: push quads off the driven roadway
            d2 = (
                (self.pts[:, None, [0, 2]] - centers_w[None, :, [0, 2]]) ** 2
            ).sum(-1)
            near = np.argmin(d2, axis=1)
            dmin = np.sqrt(d2[np.arange(n_points), near])
            clear = 4.0
            bad = dmin < clear
            if bad.any():
                c = centers_w[near[bad]]
                v = self.pts[bad] - c
                v[:, 1] = 0.0
                nv = np.linalg.norm(v, axis=1, keepdims=True)
                v = np.where(nv > 1e-6, v / np.maximum(nv, 1e-6), [[1.0, 0.0, 0.0]])
                pushed = c + v * (
                    clear + rng.uniform(1.0, 10.0, (int(bad.sum()), 1))
                )
                pushed[:, 1] = h[bad]
                self.pts[bad] = pushed.astype(np.float32)
            self._station = station
        else:
            self.pts = np.stack(
                [
                    rng.uniform(lo[0] - spread[0], hi[0] + spread[0], n_points),
                    rng.uniform(lo[1] - spread[1], hi[1] + spread[1], n_points),
                    rng.uniform(lo[2] + depth_range[0], hi[2] + depth_range[1], n_points),
                ],
                axis=-1,
            ).astype(np.float32)
        self.intensity = rng.uniform(90, 250, n_points).astype(np.float32)
        self.size_m = rng.uniform(
            size_range[0], size_range[1], n_points
        ).astype(np.float32)
        self.background = 25.0
        self.tex_f = rng.uniform(2.0, 5.0, (n_points, 2)).astype(np.float32)
        self.tex_p = rng.uniform(0, 2 * np.pi, (n_points, 2)).astype(np.float32)
        to_cam = centers_w.mean(axis=0)[None, :] - self.pts
        if kind in ("kitti", "kitti_loop"):
            to_cam = centers_w[self._station] - self.pts
        to_cam = to_cam / np.maximum(
            np.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-9
        )
        tilt = rng.normal(0.0, 0.25, (n_points, 3)).astype(np.float32)
        n = to_cam + tilt
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        up = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (n_points, 1))
        swap = np.abs((n * up).sum(-1)) > 0.95
        up[swap] = np.array([1.0, 0.0, 0.0], np.float32)
        e1 = np.cross(up, n)
        e1 = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-9)
        e2 = np.cross(n, e1)
        self.quad_n = n.astype(np.float32)
        self.quad_e1 = e1.astype(np.float32)
        self.quad_e2 = e2.astype(np.float32)

    def gt_centers(self) -> np.ndarray:
        """(T, 3) ground-truth camera centers (world)."""
        return np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in self.poses])

    def degrade(self, img: np.ndarray, i: int) -> np.ndarray:
        """Frame ``i``'s exposure gain and sensor noise, from its own
        generator, then the clip to [0, 255]."""
        if self.brightness_jitter > 0.0 or self.noise_sigma > 0.0:
            frng = np.random.default_rng((self.seed + 1) * 100003 + i)
            if self.brightness_jitter > 0.0:
                gain = 1.0 + self.brightness_jitter * float(
                    frng.uniform(-1.0, 1.0)
                )
                img = img * gain
            if self.noise_sigma > 0.0:
                img = img + frng.normal(
                    0.0, self.noise_sigma, img.shape
                ).astype(np.float32)
            img = np.clip(img, 0.0, 255.0)
        return img

    def render(self, i: int) -> np.ndarray:
        """(H, W) float32 grayscale frame i: z-buffered textured quads, the
        lens warp, the optical PSF, then exposure and noise."""
        T = self.poses[i]
        R, t = T[:3, :3], T[:3, 3]
        P_c = self.pts @ R.T + t
        n_c = self.quad_n @ R.T
        e1_c = self.quad_e1 @ R.T
        e2_c = self.quad_e2 @ R.T
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        img = np.full((self.height, self.width), self.background, np.float32)
        zbuf = np.full((self.height, self.width), np.inf, np.float32)
        s = self.size_m[:, None]
        corners = (
            P_c[:, None, :]
            + np.stack(
                [
                    s * e1_c + s * e2_c,
                    s * e1_c - s * e2_c,
                    -s * e1_c + s * e2_c,
                    -s * e1_c - s * e2_c,
                ],
                axis=1,
            )
        )
        cz = corners[..., 2]
        vis = cz.max(axis=1) > 0.3
        uc = fx * corners[..., 0] / np.maximum(cz, 0.1) + cx
        vc = fy * corners[..., 1] / np.maximum(cz, 0.1) + cy
        for j in np.nonzero(vis)[0]:
            if cz[j].min() <= 0.3:
                continue
            x0 = max(int(np.floor(uc[j].min())), 0)
            x1 = min(int(np.ceil(uc[j].max())) + 1, self.width)
            y0 = max(int(np.floor(vc[j].min())), 0)
            y1 = min(int(np.ceil(vc[j].max())) + 1, self.height)
            if x0 >= x1 or y0 >= y1:
                continue
            rx = (np.arange(x0, x1, dtype=np.float32) - cx) / fx
            ry = (np.arange(y0, y1, dtype=np.float32) - cy) / fy
            denom = rx[None, :] * n_c[j, 0] + ry[:, None] * n_c[j, 1] + n_c[j, 2]
            pn = float(P_c[j] @ n_c[j])
            with np.errstate(divide="ignore", invalid="ignore"):
                tz = pn / denom
            Xx = tz * rx[None, :] - P_c[j, 0]
            Xy = tz * ry[:, None] - P_c[j, 1]
            Xz = tz - P_c[j, 2]
            a = (Xx * e1_c[j, 0] + Xy * e1_c[j, 1] + Xz * e1_c[j, 2]) / self.size_m[j]
            b = (Xx * e2_c[j, 0] + Xy * e2_c[j, 1] + Xz * e2_c[j, 2]) / self.size_m[j]
            zwin = zbuf[y0:y1, x0:x1]
            hit = (
                (np.abs(a) <= 1.0)
                & (np.abs(b) <= 1.0)
                & (tz > 0.3)
                & (tz < zwin)
                & np.isfinite(tz)
            )
            if not hit.any():
                continue
            if self.texture > 0.0:
                pat = np.sin(
                    self.tex_f[j, 0] * a * np.pi + self.tex_p[j, 0]
                ) * np.sin(self.tex_f[j, 1] * b * np.pi + self.tex_p[j, 1])
                shade = self.intensity[j] * (
                    1.0 - self.texture * (0.5 + 0.5 * pat)
                )
            else:
                shade = np.full(hit.shape, self.intensity[j], np.float32)
            win = img[y0:y1, x0:x1]
            win[hit] = shade[hit] if self.texture > 0.0 else self.intensity[j]
            zwin[hit] = tz[hit]
        if self._warp is not None:
            su, sv = self._warp
            x0 = np.clip(np.floor(su).astype(np.int64), 0, self.width - 2)
            y0 = np.clip(np.floor(sv).astype(np.int64), 0, self.height - 2)
            fu = np.clip(su - x0, 0.0, 1.0).astype(np.float32)
            fv = np.clip(sv - y0, 0.0, 1.0).astype(np.float32)
            inside = (
                (su >= 0) & (su <= self.width - 1)
                & (sv >= 0) & (sv <= self.height - 1)
            )
            warped = (
                img[y0, x0] * (1 - fu) * (1 - fv)
                + img[y0, x0 + 1] * fu * (1 - fv)
                + img[y0 + 1, x0] * (1 - fu) * fv
                + img[y0 + 1, x0 + 1] * fu * fv
            )
            img = np.where(inside, warped, self.background).astype(np.float32)
        if self.psf_sigma > 0.0:
            img = _separable_gaussian(img, self.psf_sigma)
        return self.degrade(img, i)


class TorchRenderer:
    """``SyntheticSequence.render`` on a torch device (the card in a run,
    the CPU in the tests)."""

    def __init__(self, seq: SyntheticSequence, device):
        import torch

        self.seq, self.device = seq, torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.pts = torch.as_tensor(seq.pts, **f32)
        self.quad = torch.as_tensor(np.stack([seq.quad_n, seq.quad_e1, seq.quad_e2], 1), **f32)  # (Q, 3, 3)
        self.size = torch.as_tensor(seq.size_m, **f32)
        self.intensity = torch.as_tensor(seq.intensity, **f32)
        self.tex_f = torch.as_tensor(seq.tex_f, **f32)
        self.tex_p = torch.as_tensor(seq.tex_p, **f32)
        self.warp = None
        if seq._warp is not None:
            self.warp = tuple(torch.as_tensor(w, **f32) for w in seq._warp)
        sigma = seq.psf_sigma
        if sigma > 0.0:
            r = int(np.ceil(2.5 * sigma))
            x = np.arange(-r, r + 1, dtype=np.float32)
            k = np.exp(-0.5 * (x / sigma) ** 2)
            k /= k.sum()
            self.psf = [torch.tensor(float(w), **f32) for w in k]
        tile = torch.arange(TILE, device=self.device)
        self.tile_y, self.tile_x = tile[:, None], tile[None, :]

    def ideal(self, i: int):
        """The z-buffered quads of frame ``i``, before the lens: (H, W)."""
        import torch

        seq, dev = self.seq, self.device
        H, W = seq.height, seq.width
        T = torch.as_tensor(seq.poses[i], dtype=torch.float32, device=dev)
        R, t = T[:3, :3], T[:3, 3]
        P_c = self.pts @ R.T + t
        axes = self.quad @ R.T  # (Q, 3, 3): n, e1, e2 in the camera
        n_c, e1_c, e2_c = axes[:, 0], axes[:, 1], axes[:, 2]
        fx, fy, cx, cy = (float(v) for v in (seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2]))
        fx32, fy32, cx32, cy32 = (np.float32(v) for v in (fx, fy, cx, cy))
        s = self.size[:, None]
        corners = P_c[:, None, :] + torch.stack(
            [s * e1_c + s * e2_c, s * e1_c - s * e2_c, -s * e1_c + s * e2_c, -s * e1_c - s * e2_c], dim=1
        )
        cz = corners[..., 2]
        uc = float(fx32) * corners[..., 0] / torch.clamp(cz, min=0.1) + float(cx32)
        vc = float(fy32) * corners[..., 1] / torch.clamp(cz, min=0.1) + float(cy32)
        x0 = torch.clamp(torch.floor(uc.amin(1)), min=0).to(torch.int64)
        x1 = torch.clamp(torch.ceil(uc.amax(1)).to(torch.int64) + 1, max=W)
        y0 = torch.clamp(torch.floor(vc.amin(1)), min=0).to(torch.int64)
        y1 = torch.clamp(torch.ceil(vc.amax(1)).to(torch.int64) + 1, max=H)
        ok = (cz.amin(1) > 0.3) & (x0 < x1) & (y0 < y1)
        q = torch.nonzero(ok)[:, 0]
        x0, x1, y0, y1 = x0[q], x1[q], y0[q], y1[q]
        tx0, ty0 = x0 // TILE, y0 // TILE
        ntx, nty = (x1 - 1) // TILE - tx0 + 1, (y1 - 1) // TILE - ty0 + 1
        cnt = ntx * nty
        n_pairs = int(cnt.sum())
        key_buf = torch.full((H * W,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
        if n_pairs:
            pq = torch.repeat_interleave(torch.arange(len(q), device=dev), cnt, output_size=n_pairs)
            k = torch.arange(n_pairs, device=dev) - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt,
                                                                            output_size=n_pairs)
            px = ((tx0[pq] + k % ntx[pq]) * TILE)[:, None, None] + self.tile_x  # (P, T, T)
            py = ((ty0[pq] + k // ntx[pq]) * TILE)[:, None, None] + self.tile_y
            inbox = (px >= x0[pq, None, None]) & (px < x1[pq, None, None]) & (py >= y0[pq, None, None]) & (
                py < y1[pq, None, None])
            j = q[pq]
            rx = (px.to(torch.float32) - float(cx32)) / float(fx32)
            ry = (py.to(torch.float32) - float(cy32)) / float(fy32)
            nj, e1j, e2j = n_c[j][:, None, None], e1_c[j][:, None, None], e2_c[j][:, None, None]
            Pj = P_c[j][:, None, None]
            denom = rx * nj[..., 0] + ry * nj[..., 1] + nj[..., 2]
            pn = (P_c[j] * n_c[j]).sum(-1)[:, None, None]
            tz = pn / denom
            Xx, Xy, Xz = tz * rx - Pj[..., 0], tz * ry - Pj[..., 1], tz - Pj[..., 2]
            sz = self.size[j][:, None, None]
            a = (Xx * e1j[..., 0] + Xy * e1j[..., 1] + Xz * e1j[..., 2]) / sz
            b = (Xx * e2j[..., 0] + Xy * e2j[..., 1] + Xz * e2j[..., 2]) / sz
            hit = inbox & (torch.abs(a) <= 1.0) & (torch.abs(b) <= 1.0) & (tz > 0.3) & torch.isfinite(tz)
            # a positive float's bits order as an integer's: (depth, quad) keys
            key = (tz.contiguous().view(torch.int32).to(torch.int64) << 32) | j[:, None, None]
            pix = torch.clamp(py, max=H - 1) * W + torch.clamp(px, max=W - 1)
            key = torch.where(hit, key, torch.iinfo(torch.int64).max)
            key_buf.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), reduce="amin")
        img = torch.full((H * W,), seq.background, dtype=torch.float32, device=dev)
        won = key_buf != torch.iinfo(torch.int64).max
        if bool(won.any()):
            pix = torch.nonzero(won)[:, 0]
            j = key_buf[pix] & 0xFFFFFFFF
            py, px = pix // W, pix % W
            rx = (px.to(torch.float32) - float(cx32)) / float(fx32)
            ry = (py.to(torch.float32) - float(cy32)) / float(fy32)
            denom = rx * n_c[j, 0] + ry * n_c[j, 1] + n_c[j, 2]
            tz = (P_c[j] * n_c[j]).sum(-1) / denom
            Xx, Xy, Xz = tz * rx - P_c[j, 0], tz * ry - P_c[j, 1], tz - P_c[j, 2]
            a = (Xx * e1_c[j, 0] + Xy * e1_c[j, 1] + Xz * e1_c[j, 2]) / self.size[j]
            b = (Xx * e2_c[j, 0] + Xy * e2_c[j, 1] + Xz * e2_c[j, 2]) / self.size[j]
            if seq.texture > 0.0:
                pat = torch.sin(self.tex_f[j, 0] * a * float(np.float32(np.pi)) + self.tex_p[j, 0]) * torch.sin(
                    self.tex_f[j, 1] * b * float(np.float32(np.pi)) + self.tex_p[j, 1])
                shade = self.intensity[j] * (1.0 - float(np.float32(seq.texture)) * (0.5 + 0.5 * pat))
            else:
                shade = self.intensity[j]
            img[pix] = shade
        return img.view(H, W)

    def render(self, i: int) -> np.ndarray:
        """Frame ``i`` as ``SyntheticSequence.render`` gives it."""
        import torch
        import torch.nn.functional as F

        seq = self.seq
        img = self.ideal(i)
        H, W = img.shape
        if self.warp is not None:
            su, sv = self.warp
            x0 = torch.clamp(torch.floor(su).to(torch.int64), 0, W - 2)
            y0 = torch.clamp(torch.floor(sv).to(torch.int64), 0, H - 2)
            fu = torch.clamp(su - x0, 0.0, 1.0)
            fv = torch.clamp(sv - y0, 0.0, 1.0)
            inside = (su >= 0) & (su <= W - 1) & (sv >= 0) & (sv <= H - 1)
            warped = (img[y0, x0] * (1 - fu) * (1 - fv) + img[y0, x0 + 1] * fu * (1 - fv)
                      + img[y0 + 1, x0] * (1 - fu) * fv + img[y0 + 1, x0 + 1] * fu * fv)
            img = torch.where(inside, warped, torch.full_like(warped, seq.background))
        if seq.psf_sigma > 0.0:
            r = len(self.psf) // 2
            pad = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
            out = torch.zeros_like(img)
            for k, w in enumerate(self.psf):
                out = out + w * pad[k : k + H, :]
            pad = F.pad(out[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
            img = torch.zeros_like(img)
            for k, w in enumerate(self.psf):
                img = img + w * pad[:, k : k + W]
        return seq.degrade(img.cpu().numpy(), i)
