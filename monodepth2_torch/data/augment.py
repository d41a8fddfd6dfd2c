"""Triplet-consistent augmentations, copied from monodepth2_tpu/data/augment.py
(reference: Augmentations.jl FlipX(0.5) applied to the whole triplet,
src/Monodepth.jl:84 + src/kitty.jl:53-54)."""

from __future__ import annotations

from typing import List

import numpy as np


class FlipX:
    """Horizontally flip all frames of a triplet with probability p.

    Flipping all frames together preserves the epipolar geometry of the
    triplet (a per-frame flip would corrupt the pose-learning signal).
    """

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, frames: List[np.ndarray], rng: np.random.Generator):
        """frames: list of (H,W,C) arrays; one coin flip for the whole list."""
        if rng.uniform() < self.p:
            return [np.ascontiguousarray(f[:, ::-1]) for f in frames]
        return frames


class Compose:
    def __init__(self, *transforms):
        self.transforms = transforms

    def __call__(self, frames, rng):
        for t in self.transforms:
            frames = t(frames, rng)
        return frames


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Align-corners bilinear resize of an (H, W, C) float array (the
    reference resizes via ImageTransformations.imresize, src/kitty.jl:51)."""
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img
    ys = np.linspace(0, h - 1, height)
    xs = np.linspace(0, w - 1, width)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(np.float32)[:, None, None]
    wx = (xs - x0).astype(np.float32)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)
