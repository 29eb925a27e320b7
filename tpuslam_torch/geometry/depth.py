"""Disparity <-> depth conversion (monodepth2 convention).

Counterpart of `tpuslam/geometry/depth.py`.  With max_depth=None the
disparity is floored at 1e-4: a saturated sigmoid underflows to exactly 0 in
f32, and 1/0 depth would turn into NaN coordinates and NaN gradients.  Every
non-degenerate value is unchanged by the floor.
"""
from __future__ import annotations

from typing import Optional

import torch

_DISP_FLOOR = 1e-4


def disp_to_depth(
    disp: torch.Tensor,
    min_depth: Optional[float] = None,
    max_depth: Optional[float] = None,
) -> torch.Tensor:
    if min_depth is None and max_depth is None:
        return 1.0 / torch.clamp_min(disp, _DISP_FLOOR)
    if max_depth is None:
        return min_depth / torch.clamp_min(disp, _DISP_FLOOR)
    if min_depth is None:
        raise ValueError("min_depth is None while max_depth is set")
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)


def depth_to_disp(
    depth: float,
    min_depth: Optional[float] = None,
    max_depth: Optional[float] = None,
) -> float:
    """Exact inverse of `disp_to_depth` for a scalar target depth (used by
    the anti-collapse scale prior)."""
    if min_depth is None and max_depth is None:
        return 1.0 / depth
    if max_depth is None:
        return min_depth / depth
    if min_depth is None:
        raise ValueError("min_depth is None while max_depth is set")
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return (1.0 / depth - min_disp) / (max_disp - min_disp)
