"""Deterministic synthetic triplet datasets for tests and benchmarks, copied
from monodepth2_tpu/data/synthetic.py (numpy only; the port imports nothing
of the JAX package). Each dataset makes its frames from a seed, so nothing is
downloaded.

`SyntheticTriplets`: textured scenes at three horizontally-shifted camera
positions — a fast stand-in for KITTI when no data is on disk.

`SyntheticGroundPlane`: geometrically-consistent triplets rendered from a
known depth map (fronto-parallel wall + ground plane) under a known lateral
camera translation, with the ground-truth depth exposed.

`SyntheticDriving`: driving-like triplets ray-cast from a 3D scene (forward
ego-motion with yaw, billboards, procedural texture), pixel-consistent with
`gt_depth_for(i)` and `gt_poses_for(i)`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SyntheticTriplets:
    def __init__(
        self,
        n: int = 64,
        target_size: Tuple[int, int] = (416, 128),
        channels: int = 1,
        shift: int = 2,
        seed: int = 0,
    ):
        self.n = n
        self.width, self.height = target_size
        self.channels = channels
        self.shift = shift
        self.seed = seed
        f = 0.58 * self.width * 2  # KITTI-ish focal after resize
        self.K = np.asarray(
            [[f, 0, self.width / 2], [0, f, self.height / 2], [0, 0, 1.0]],
            np.float64,
        )
        self.invK = np.linalg.inv(self.K)
        self.target_id = 1
        self.source_ids = (0, 2)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        g = np.random.default_rng(self.seed * 100003 + i)
        h, w, c = self.height, self.width, self.channels
        base = g.uniform(size=(h, w + 2 * self.shift, c)).astype(np.float32)
        # smooth into image-like texture
        for axis in (0, 1):
            base = (
                base
                + np.roll(base, 1, axis=axis)
                + np.roll(base, -1, axis=axis)
            ) / 3.0
        base /= base.max()
        s = self.shift
        frames = [
            base[:, 2 * s : 2 * s + w],
            base[:, s : s + w],
            base[:, 0:w],
        ]
        return np.stack(frames, axis=0)  # (3,H,W,C)


class SyntheticGroundPlane:
    """Triplets with exact geometry: a textured scene at known depth
    (ground plane meeting a far wall), viewed from laterally-shifted cameras.

    Rendering inverts the training warp: for each source camera at lateral
    offset ±tx, the source image is the target texture sampled at
    u' = u + fx·tx/depth(v) (pure horizontal parallax). `gt_depth` is the
    (H, W) metric depth of the target view, so eval_depth_accuracy can score
    a trained model with zero external data.
    """

    def __init__(
        self,
        n: int = 64,
        target_size: Tuple[int, int] = (416, 128),
        channels: int = 1,
        tx: float = 0.15,
        horizon: float = 0.45,
        wall_depth: float = 40.0,
        camera_height: float = 1.5,
        seed: int = 0,
    ):
        self.n = n
        self.width, self.height = target_size
        self.channels = channels
        self.tx = tx
        self.seed = seed
        f = 0.58 * self.width * 2
        self.K = np.asarray(
            [[f, 0, self.width / 2], [0, f, self.height / 2], [0, 0, 1.0]],
            np.float64,
        )
        self.invK = np.linalg.inv(self.K)
        self.target_id = 1
        self.source_ids = (0, 2)

        # depth map: rows above the horizon see the far wall; below, a ground
        # plane at camera_height: depth = fy * h_cam / (v - horizon_row)
        h, w = self.height, self.width
        v = np.arange(h, dtype=np.float64)
        horizon_row = horizon * h
        fy = self.K[1, 1]
        ground = fy * camera_height / np.maximum(v - horizon_row, 1e-6)
        depth_rows = np.where(v <= horizon_row, wall_depth, np.minimum(ground, wall_depth))
        self.gt_depth = np.tile(depth_rows[:, None], (1, w)).astype(np.float32)

    def __len__(self) -> int:
        return self.n

    def _texture(self, i: int) -> np.ndarray:
        g = np.random.default_rng(self.seed * 99991 + i)
        h, w, c = self.height, self.width, self.channels
        pad = 64
        tex = g.uniform(size=(h, w + 2 * pad, c)).astype(np.float32)
        for _ in range(2):
            for axis in (0, 1):
                tex = (tex + np.roll(tex, 1, axis) + np.roll(tex, -1, axis)) / 3.0
        tex -= tex.min()
        tex /= max(tex.max(), 1e-6)
        return tex, pad

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        tex, pad = self._texture(i)
        h, w = self.height, self.width
        fx = self.K[0, 0]
        target = tex[:, pad : pad + w]
        # per-row horizontal parallax in pixels: fx * tx / depth(v)
        shift = fx * self.tx / self.gt_depth[:, 0]  # (H,)
        xs = np.arange(w, dtype=np.float64)[None, :] + pad

        def render(sign: float) -> np.ndarray:
            # sample texture at u + sign*shift with linear interpolation
            u = xs + sign * shift[:, None]
            u = np.clip(u, 0, tex.shape[1] - 1)
            x0 = np.floor(u).astype(np.int64)
            x1 = np.minimum(x0 + 1, tex.shape[1] - 1)
            wu = (u - x0).astype(np.float32)[..., None]
            rows = np.arange(h)[:, None]
            return tex[rows, x0] * (1 - wu) + tex[rows, x1] * wu

        prev = render(+1.0)   # camera moved -tx: scene appears shifted +
        nxt = render(-1.0)
        return np.stack([prev, target, nxt], axis=0).astype(np.float32)


def _yaw_matrix(theta: float) -> np.ndarray:
    """Rotation about the camera y axis (x right, y down, z forward)."""
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


class SyntheticDriving:
    """Driving-like triplets from a ray-cast 3D scene: forward ego-motion with
    yaw, per-pixel depth structure, and procedural multi-band texture — the
    geometry regime KITTI trains in (the round-1 synthetic sets had only
    symmetric lateral shifts, which VALIDATION.md implicates in the SSL
    saturation attractors).

    World frame = the target camera's frame (x right, y down, z forward).
    Scene: a ground plane at y=+camera_height, a far wall, and `n_boxes`
    vertical billboards (constant-z rectangles standing on the ground) at
    random depths/positions — every surface textured by a deterministic sum
    of 2D cosines with per-surface albedo, so occlusion boundaries carry both
    depth and intensity edges.

    Cameras at times (-1, 0, +1): speed·t forward along an arc with constant
    yaw rate, plus small lateral/vertical jitter. Rendering is exact inverse
    ray casting (nearest positive plane hit), so the three views are pixel-
    consistent with `gt_depth_for(i)` and `gt_poses_for(i)` — the same
    contract the training warp assumes (ops/geometry.py conventions):
    p_src = R p_tgt + t with R = R_srcᵀ R_tgt, t = R_srcᵀ (c_tgt − c_src).
    """

    def __init__(
        self,
        n: int = 64,
        target_size: Tuple[int, int] = (416, 128),
        channels: int = 1,
        n_boxes: int = 10,
        speed: Tuple[float, float] = (0.5, 1.5),
        yaw_rate: float = 0.02,
        jitter: float = 0.03,
        camera_height: float = 1.5,
        wall_depth: float = 60.0,
        seed: int = 0,
        cache: bool = True,
        focal_scale: float = 1.0,
    ):
        self.n = n
        self.width, self.height = target_size
        self.channels = channels
        self.n_boxes = n_boxes
        self.speed = speed
        self.yaw_rate = yaw_rate
        self.jitter = jitter
        self.camera_height = camera_height
        self.wall_depth = wall_depth
        self.seed = seed
        # ray casting costs ~0.2 s/triplet; memoize so multi-epoch training
        # is bound by the card, not the renderer (~0.6 MB per cached triplet)
        self._cache: Optional[dict] = {} if cache else None
        # focal_scale renders a camera with a different calibration — the
        # ray caster derives rays from self.invK, so frames/GT stay
        # pixel-consistent. Lets tests/experiments build heterogeneous-K
        # chains with honest geometry (per_item_K evidence).
        f = 0.58 * self.width * 2 * focal_scale
        self.K = np.asarray(
            [[f, 0, self.width / 2], [0, f, self.height / 2], [0, 0, 1.0]],
            np.float64,
        )
        self.invK = np.linalg.inv(self.K)
        self.target_id = 1
        self.source_ids = (0, 2)

    def __len__(self) -> int:
        return self.n

    # ---- scene sampling -------------------------------------------------
    def _scene(self, i: int):
        """Billboards: list of (z, x0, x1, y_top) rects standing on the
        ground (y from y_top to camera_height); plus texture coefficient
        banks for ground / wall / each billboard."""
        g = np.random.default_rng([self.seed, 11, i])
        boxes = []
        for _ in range(self.n_boxes):
            z = g.uniform(4.0, 35.0)
            xc = g.uniform(-0.35, 0.35) * z  # keep inside the frustum
            half_w = g.uniform(0.5, 2.5)
            height = g.uniform(1.0, 4.0)
            boxes.append((z, xc - half_w, xc + half_w, self.camera_height - height))
        # sort far→near so textures are stable regardless of count
        boxes.sort(key=lambda b: -b[0])

        def bank(key, n_waves=12):
            gg = np.random.default_rng([self.seed, 13, i, key])
            freq = np.exp(gg.uniform(np.log(0.3), np.log(6.0), size=(n_waves, 2)))
            angle = gg.uniform(0, 2 * np.pi, size=n_waves)
            fvec = freq * np.stack([np.cos(angle), np.sin(angle)], axis=1)
            phase = gg.uniform(0, 2 * np.pi, size=(n_waves, self.channels))
            amp = gg.uniform(0.3, 1.0, size=(n_waves, 1)) / np.sqrt(n_waves)
            albedo = gg.uniform(0.35, 0.95, size=self.channels)
            return fvec, phase, amp, albedo

        banks = [bank(0), bank(1)] + [bank(2 + k) for k in range(len(boxes))]
        return boxes, banks

    @staticmethod
    def _shade(uv: np.ndarray, bank) -> np.ndarray:
        """uv (M,2) surface coords -> (M,C) texture in (0,1)."""
        fvec, phase, amp, albedo = bank
        arg = 2 * np.pi * (uv @ fvec.T)  # (M, n_waves)
        val = (np.sin(arg[..., None] + phase[None]) * amp[None]).sum(axis=1)
        return np.clip(albedo[None] * (0.5 + 0.35 * val), 0.0, 1.0)

    # ---- camera trajectory ----------------------------------------------
    def _poses(self, i: int):
        """World-from-camera (R, c) for times (-1, 0, +1); target at t=0 is
        the identity (world frame = target camera frame)."""
        g = np.random.default_rng([self.seed, 17, i])
        v = g.uniform(*self.speed)
        omega = g.uniform(-self.yaw_rate, self.yaw_rate)
        poses = []
        for t in (-1.0, 0.0, 1.0):
            R = _yaw_matrix(omega * t)
            heading = _yaw_matrix(omega * t / 2.0)[:, 2]  # midpoint-arc chord
            c = v * t * heading
            if t != 0.0:
                c = c + g.uniform(-self.jitter, self.jitter, size=3) * [1, 0.3, 1]
            poses.append((R, c))
        return poses

    def gt_poses_for(self, i: int):
        """Target→source rigid transforms [(R, t)] per source id, in the
        training warp's convention (p_src = R p_tgt + t)."""
        poses = self._poses(i)
        R_t, c_t = poses[self.target_id]
        out = []
        for sid in self.source_ids:
            R_s, c_s = poses[sid]
            R_rel = R_s.T @ R_t
            t_rel = (R_s.T @ (c_t - c_s))[:, None]
            out.append((R_rel, t_rel))
        return out

    # ---- rendering --------------------------------------------------------
    def _render(self, boxes, banks, R: np.ndarray, c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Ray-cast one view; returns (image (H,W,C), z-depth (H,W))."""
        h, w = self.height, self.width
        u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        d_cam = np.stack([u.ravel(), v.ravel(), np.ones(h * w)], axis=0)
        d_cam = self.invK @ d_cam  # (3, HW), z-component == 1
        d = R @ d_cam  # world directions; ray p(t) = c + t·d, t == z-depth

        INF = np.inf
        best_t = np.full(h * w, INF)
        best_sid = np.full(h * w, -1, np.int64)

        # ground plane y = camera_height  (surface 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            tg = (self.camera_height - c[1]) / d[1]
        ok = (d[1] > 1e-9) & (tg > 0.05)
        upd = ok & (tg < best_t)
        best_t[upd] = tg[upd]
        best_sid[upd] = 0

        # far wall z = wall_depth  (surface 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            tw = (self.wall_depth - c[2]) / d[2]
        ok = (d[2] > 1e-9) & (tw > 0.05)
        upd = ok & (tw < best_t)
        best_t[upd] = tw[upd]
        best_sid[upd] = 1

        # billboards (surfaces 2..)
        for k, (z, x0, x1, y_top) in enumerate(boxes):
            with np.errstate(divide="ignore", invalid="ignore"):
                tb = (z - c[2]) / d[2]
            px = c[0] + tb * d[0]
            py = c[1] + tb * d[1]
            ok = (
                (np.abs(d[2]) > 1e-9)
                & (tb > 0.05)
                & (px >= x0)
                & (px <= x1)
                & (py >= y_top)
                & (py <= self.camera_height + 1e-9)
            )
            upd = ok & (tb < best_t)
            best_t[upd] = tb[upd]
            best_sid[upd] = 2 + k

        # any still-unhit rays (grazing the ground/wall seam): clamp to wall
        miss = ~np.isfinite(best_t)
        best_t[miss] = self.wall_depth
        best_sid[miss] = 1

        img = np.zeros((h * w, self.channels), np.float32)
        hit = c[:, None] + best_t[None] * d  # (3, HW) world points
        for sid in range(2 + len(boxes)):
            m = best_sid == sid
            if not m.any():
                continue
            if sid == 0:  # ground: (x, z) coords
                uvs = np.stack([hit[0, m], hit[2, m]], axis=1)
            else:  # wall/billboards: (x, y) coords
                uvs = np.stack([hit[0, m], hit[1, m]], axis=1)
            img[m] = self._shade(uvs, banks[sid])
        return img.reshape(h, w, self.channels), best_t.reshape(h, w).astype(np.float32)

    def gt_depth_for(self, i: int) -> np.ndarray:
        boxes, banks = self._scene(i)
        R, c = self._poses(i)[self.target_id]
        return self._render(boxes, banks, R, c)[1]

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        boxes, banks = self._scene(i)
        frames = [
            self._render(boxes, banks, R, c)[0] for (R, c) in self._poses(i)
        ]
        out = np.stack(frames, axis=0).astype(np.float32)  # (3,H,W,C)
        if self._cache is not None:
            self._cache[i] = out
        return out
