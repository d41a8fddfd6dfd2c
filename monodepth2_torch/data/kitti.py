"""KITTI odometry triplet dataset, copied from monodepth2_tpu/data/kitti.py
(reference: src/kitty.jl). Frames decode through the native decoder
(data/native.py) when it builds, else through PIL, imported where a frame is
read; `decoder` says which ("native" or "pil"), and a fallback the caller
did not ask for warns with the build's error.

Layout expected (same as the reference):
    <root>/sequences/<seq>/calib.txt       — P0 projection on the first line
    <root>/sequences/<seq>/image_0/%06d.png — grayscale frames

Each item is a non-overlapping frame triplet (3i, 3i+1, 3i+2), resized to
`target_size`, optionally augmented, returned as float32 (3, H, W, C).
Intrinsics: fx from calib P0 rescaled by the mean resize ratio, principal
point at the image center (reference src/kitty.jl:27-29).
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Optional, Tuple

import numpy as np


def parse_calib_K(calib_path: str) -> np.ndarray:
    """Parse the 3×4 P0 line of a KITTI calib.txt into a 3×3 K
    (reference parse_matrix, src/kitty.jl:73-77)."""
    with open(calib_path) as f:
        line = f.readline().strip()
    if ":" in line:
        line = line.split(":", 1)[1]
    vals = np.asarray([float(v) for v in line.split()], np.float64)
    P = vals.reshape(3, 4)
    return P[:3, :3].copy()


def native_decoder(use_native: bool):
    """The native module when asked for and built, else None (PIL). A
    fallback warns with the build's error, so that it is not silent."""
    if not use_native:
        return None
    from . import native

    if native.available():
        return native
    warnings.warn(f"native decoder unavailable, decoding through PIL: {native.build_error()}", stacklevel=3)
    return None


def construct_intrinsic(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    return np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], np.float64)


class KittiDataset:
    """target_size is (width, height) — note the reference takes (h, w) and
    flips internally; here width-first matches TrainConfig.target_size."""

    def __init__(
        self,
        root: str,
        sequence: str,
        target_size: Tuple[int, int] = (416, 128),
        augmentations=None,
        grayscale: bool = True,
        frame_ids: Tuple[int, ...] = (0, 1, 2),
        use_native: bool = True,
        cache_decoded: bool = False,
    ):
        from PIL import Image

        seq_dir = os.path.join(root, "sequences", sequence)
        self.frames_dir = os.path.join(seq_dir, "image_0")
        self.width, self.height = target_size
        self.augmentations = augmentations
        self.grayscale = grayscale
        self.frame_ids = frame_ids

        files = sorted(f for f in os.listdir(self.frames_dir) if f.endswith(".png"))
        if not files:
            raise FileNotFoundError(f"no frames in {self.frames_dir}")
        self.n_frames = len(files)
        with Image.open(os.path.join(self.frames_dir, files[0])) as im:
            orig_w, orig_h = im.size

        K0 = parse_calib_K(os.path.join(seq_dir, "calib.txt"))
        # rescale focal by the mean target/original ratio; principal point at
        # center (reference src/kitty.jl:27-29)
        ratio = float(np.mean([self.height / orig_h, self.width / orig_w]))
        fx = ratio * K0[0, 0]
        self.K = construct_intrinsic(fx, fx, self.width // 2, self.height // 2)
        self.invK = np.linalg.inv(self.K)

        self.target_id = 1
        self.source_ids = (0, 2)
        self._native = native_decoder(use_native)
        self.decoder = "pil" if self._native is None else "native"

        # RAM cache of resized uint8 frames (53 KB/frame at 416×128 gray):
        # every epoch after the first is decode-free. Values are u8-quantized
        # on the fill pass too, so all epochs see identical pixels.
        self._cache = {} if cache_decoded else None
        self._cache_lock = threading.Lock() if cache_decoded else None

    def __len__(self) -> int:
        return self.n_frames // len(self.frame_ids)

    def _load_frame(self, idx: int) -> np.ndarray:
        from PIL import Image

        if self._cache is not None:
            with self._cache_lock:
                hit = self._cache.get(idx)
            if hit is not None:
                return hit.astype(np.float32) / 255.0
        path = os.path.join(self.frames_dir, f"{idx:06d}.png")
        if self._native is not None:
            arr = self._native.load_resize(path, self.width, self.height, 1 if self.grayscale else 3)
        else:
            with Image.open(path) as im:
                im = im.convert("L" if self.grayscale else "RGB")
                im = im.resize((self.width, self.height), Image.BILINEAR)
                arr = np.asarray(im, np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[..., None]
        if self._cache is not None:
            u8 = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
            with self._cache_lock:
                self._cache[idx] = u8
            return u8.astype(np.float32) / 255.0
        return arr

    def __getitem__(self, i: int, rng: Optional[np.random.Generator] = None):
        base = i * len(self.frame_ids)
        frames = [self._load_frame(base + fid) for fid in self.frame_ids]
        if self.augmentations is not None:
            rng = rng or np.random.default_rng()
            frames = self.augmentations(frames, rng)
        return np.stack(frames, axis=0)  # (3,H,W,C)
