"""Depth evaluation: the 8 standard monodepth metrics with median scaling.

Formula parity with the reference (reference slam/utils.py:389-443):
resize prediction to GT resolution, mask invalid GT, optional median
scaling (SfMLearner), min/max capping, then abs_diff / abs_rel / sq_rel /
a1 / a2 / a3 / rmse / rmse_log.  The resize here is PIL bilinear instead of
cv2 (not shipped in this environment); both are standard bilinear.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from PIL import Image


def _resize_bilinear(pred: np.ndarray, height: int, width: int) -> np.ndarray:
    if pred.shape == (height, width):
        return pred
    img = Image.fromarray(pred.astype(np.float32), mode="F")
    return np.asarray(img.resize((width, height), Image.BILINEAR), np.float32)


def calc_depth_error(
    pred_depth: np.ndarray,
    gt_depth: np.ndarray,
    median_scaling: bool = True,
    min_depth: Optional[float] = 0.1,
    max_depth: Optional[float] = None,
) -> Dict[str, float]:
    gt_h, gt_w = gt_depth.shape
    pred = _resize_bilinear(np.asarray(pred_depth, np.float32), gt_h, gt_w)
    gt = np.asarray(gt_depth, np.float32)

    if max_depth is not None:
        mask = (gt > min_depth) & (gt < max_depth)
    else:
        mask = gt > min_depth
    pred = pred[mask]
    gt = gt[mask]
    if pred.size == 0:
        return {k: float("nan") for k in (
            "abs_diff", "abs_rel", "sq_rel", "a1", "a2", "a3", "rmse", "rmse_log")}

    if median_scaling:
        pred = pred * (np.median(gt) / np.median(pred))

    pred = np.clip(pred, min_depth, max_depth if max_depth is not None else np.inf)

    thresh = np.maximum(gt / pred, pred / gt)
    return {
        "abs_diff": float(np.mean(np.abs(gt - pred))),
        "abs_rel": float(np.mean(np.abs(gt - pred) / gt)),
        "sq_rel": float(np.mean((gt - pred) ** 2 / gt)),
        "a1": float(np.mean(thresh < 1.25)),
        "a2": float(np.mean(thresh < 1.25**2)),
        "a3": float(np.mean(thresh < 1.25**3)),
        "rmse": float(np.sqrt(np.mean((gt - pred) ** 2))),
        "rmse_log": float(np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2))),
    }
