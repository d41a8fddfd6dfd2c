"""Disparity / warped-image PNG output, port of monodepth2_tpu/utils/viz.py
(reference: src/io_utils.jl).

The thermal colormap LUT is copied; PIL writes the PNGs, imported where it
writes them."""

from __future__ import annotations

import numpy as np

# 8-stop approximation of the GR :thermal colormap (dark blue → purple →
# orange → yellow-white), linearly interpolated to 256 entries.
_THERMAL_STOPS = np.asarray(
    [
        [4, 35, 51],
        [30, 60, 115],
        [87, 68, 166],
        [148, 77, 155],
        [205, 88, 123],
        [240, 120, 85],
        [250, 174, 82],
        [232, 250, 91],
    ],
    np.float32,
)


def _thermal_lut() -> np.ndarray:
    xs = np.linspace(0, len(_THERMAL_STOPS) - 1, 256)
    i0 = np.floor(xs).astype(int)
    i1 = np.minimum(i0 + 1, len(_THERMAL_STOPS) - 1)
    w = (xs - i0)[:, None]
    return (_THERMAL_STOPS[i0] * (1 - w) + _THERMAL_STOPS[i1] * w).astype(np.uint8)


_LUT = _thermal_lut()


def _save_png(image: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(image).save(path)


def colorize_disparity(disparity: np.ndarray) -> np.ndarray:
    """(H,W) disparity -> (H,W,3) uint8 thermal heatmap, min-max normalized."""
    d = np.asarray(disparity, np.float32)
    lo, hi = float(d.min()), float(d.max())
    if hi - lo < 1e-12:
        idx = np.zeros(d.shape, np.int32)
    else:
        idx = np.clip(((d - lo) / (hi - lo)) * 255.0, 0, 255).astype(np.int32)
    return _LUT[idx]


def save_disparity(disparity, path: str) -> None:
    """Save an (H,W) or (H,W,1) disparity map as a heatmap PNG
    (reference save_disparity, src/io_utils.jl:1-7)."""
    d = np.asarray(disparity)
    if d.ndim == 3:
        d = d[..., 0]
    _save_png(colorize_disparity(d), path)


def save_warped(warped, path: str) -> None:
    """Save an (H,W,C) float image in [0,1] as PNG
    (reference save_warped, src/io_utils.jl:9-21)."""
    w = np.asarray(warped)
    if w.ndim == 3 and w.shape[-1] == 1:
        w = w[..., 0]
    _save_png(np.clip(w * 255.0, 0, 255).astype(np.uint8), path)
