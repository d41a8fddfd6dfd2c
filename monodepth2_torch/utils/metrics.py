"""Depth-accuracy metrics (AbsRel, SqRel, RMSE, RMSElog, δ<1.25^k), copied
from monodepth2_tpu/utils/metrics.py (numpy only; the port imports nothing
of the JAX package).

The standard Monodepth2-paper evaluation: median scaling (monocular scale
ambiguity), clamped to the eval depth range.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def depth_metrics(
    pred_depth: np.ndarray,
    gt_depth: np.ndarray,
    min_depth: float = 1e-3,
    max_depth: float = 80.0,
    median_scaling: bool = True,
    mask: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """pred/gt (H,W) or flattened; gt==0 treated as invalid."""
    pred = np.asarray(pred_depth, np.float64).ravel()
    gt = np.asarray(gt_depth, np.float64).ravel()
    valid = (gt > min_depth) & (gt < max_depth)
    if mask is not None:
        valid &= np.asarray(mask).ravel().astype(bool)
    pred, gt = pred[valid], gt[valid]
    if pred.size == 0:
        return {k: float("nan") for k in
                ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3", "scale")}

    scale = 1.0
    if median_scaling:
        scale = np.median(gt) / np.median(pred)
        pred = pred * scale
    pred = np.clip(pred, min_depth, max_depth)

    thresh = np.maximum(gt / pred, pred / gt)
    err = pred - gt
    log_err = np.log(pred) - np.log(gt)
    return {
        "abs_rel": float(np.mean(np.abs(err) / gt)),
        "sq_rel": float(np.mean(err**2 / gt)),
        "rmse": float(np.sqrt(np.mean(err**2))),
        "rmse_log": float(np.sqrt(np.mean(log_err**2))),
        "a1": float(np.mean(thresh < 1.25)),
        "a2": float(np.mean(thresh < 1.25**2)),
        "a3": float(np.mean(thresh < 1.25**3)),
        "scale": float(scale),
    }
