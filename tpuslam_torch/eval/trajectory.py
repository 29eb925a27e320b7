"""Trajectory evaluation: KITTI-odometry-style metrics.

Formula parity with the reference's evaluation utilities
(reference slam/utils.py:124-383, themselves derived from the public
kitti-odom-eval): segment translation/rotation errors over 100-800 m windows
sampled every 10 frames, ATE RMSE, RPE, least-squares scale alignment, and
the same final report string format so downstream log parsing keeps working.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

SEGMENT_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)
_STEP_SIZE = 10


def rotation_error(pose_error: np.ndarray) -> float:
    """Geodesic rotation angle of a relative pose error."""
    trace = pose_error[0, 0] + pose_error[1, 1] + pose_error[2, 2]
    return float(np.arccos(np.clip(0.5 * (trace - 1.0), -1.0, 1.0)))


def translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


def trajectory_distances(poses: Sequence[np.ndarray]) -> np.ndarray:
    xyz = np.stack([p[:3, 3] for p in poses])
    steps = np.linalg.norm(np.diff(xyz, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(steps)])


def scale_lse(X: np.ndarray, Y: np.ndarray) -> float:
    """argmin_s ||sX - Y||^2 = sum(XY)/sum(X^2)."""
    return float(np.sum(X * Y) / np.sum(X * X))


def scale_optimization(
    pred_poses: List[np.ndarray], gt_poses: List[np.ndarray]
) -> Tuple[List[np.ndarray], float]:
    """Scale predicted translations to best match GT (keep rotations)."""
    pred_xyz = np.stack([p[:3, 3] for p in pred_poses])
    gt_xyz = np.stack([p[:3, 3] for p in gt_poses])
    s = scale_lse(pred_xyz, gt_xyz)
    scaled = []
    for p in pred_poses:
        q = p.copy()
        q[:3, 3] *= s
        scaled.append(q)
    return scaled, s


def _segment_end(dist: np.ndarray, first: int, length: float) -> int:
    ends = np.nonzero(dist[first:] > dist[first] + length)[0]
    return int(first + ends[0]) if len(ends) else -1


def sequence_errors(
    pred_poses: List[np.ndarray], gt_poses: List[np.ndarray]
) -> List[Tuple[int, float, float, float, float]]:
    """Per-(start, length) errors: (first, rot/len, trans/len, length, speed)."""
    dist = trajectory_distances(gt_poses)
    out = []
    for first in range(0, len(gt_poses), _STEP_SIZE):
        for length in SEGMENT_LENGTHS:
            last = _segment_end(dist, first, length)
            if last == -1:
                continue
            gt_delta = np.linalg.inv(gt_poses[first]) @ gt_poses[last]
            pred_delta = np.linalg.inv(pred_poses[first]) @ pred_poses[last]
            err = np.linalg.inv(pred_delta) @ gt_delta
            num_frames = last - first + 1
            speed = length / (0.1 * num_frames)
            out.append(
                (
                    first,
                    rotation_error(err) / length,
                    translation_error(err) / length,
                    length,
                    speed,
                )
            )
    return out


def average_segment_errors(seq_errs) -> Dict[float, List[float]]:
    by_len: Dict[float, List[List[float]]] = {l: [] for l in SEGMENT_LENGTHS}
    for _, r, t, length, _ in seq_errs:
        by_len[length].append([t, r])
    return {
        l: (list(np.mean(v, axis=0)) if v else []) for l, v in by_len.items()
    }


def overall_error(seq_errs) -> Tuple[float, float]:
    if not seq_errs:
        return 0.0, 0.0
    arr = np.asarray([(t, r) for _, r, t, _, _ in seq_errs])
    return float(arr[:, 0].mean()), float(arr[:, 1].mean())


def compute_ate(pred_poses, gt_poses) -> float:
    """RMSE of absolute trajectory (translation) error."""
    d = [
        np.linalg.norm(g[:3, 3] - p[:3, 3])
        for p, g in zip(pred_poses, gt_poses)
    ]
    return float(np.sqrt(np.mean(np.square(d))))


def compute_rpe(pred_poses, gt_poses) -> Tuple[float, float]:
    """Mean frame-to-frame relative pose error (translation m, rotation rad)."""
    terrs, rerrs = [], []
    for i in range(len(pred_poses) - 1):
        gt_rel = np.linalg.inv(gt_poses[i]) @ gt_poses[i + 1]
        pred_rel = np.linalg.inv(pred_poses[i]) @ pred_poses[i + 1]
        err = np.linalg.inv(gt_rel) @ pred_rel
        terrs.append(translation_error(err))
        rerrs.append(rotation_error(err))
    return float(np.mean(terrs)), float(np.mean(rerrs))


def calc_error(
    pred_poses: List[np.ndarray],
    gt_poses: List[np.ndarray],
    optimize_scale: bool = False,
) -> str:
    """Formatted error report (same fields/format as slam/utils.py:357-383)."""
    log = ""
    if optimize_scale:
        pred_scaled, scaling = scale_optimization(pred_poses, gt_poses)
        log += "-" * 10 + " MEDIAN\n"
        log += f"Scaling: {scaling}"
    else:
        pred_scaled = pred_poses
    ave_t, ave_r = overall_error(sequence_errors(pred_scaled, gt_poses))
    log += "-" * 10 + "\n"
    log += f"Trans error (%):      {ave_t * 100:.4f}\n"
    log += f"Rot error (deg/100m): {100 * ave_r / np.pi * 180:.4f}\n"
    ate = compute_ate(pred_poses, gt_poses)
    log += f"Abs traj RMSE (m):    {ate:.4f}\n"
    rpe_t, rpe_r = compute_rpe(pred_poses, gt_poses)
    log += f"Rel pose error (m):   {rpe_t:.4f}\n"
    log += f"Rel pose err (deg):   {rpe_r * 180 / np.pi:.4f}\n"
    log += "-" * 10 + "\n"
    return log
