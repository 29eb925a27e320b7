"""Host-side SE(3) convenience helpers (numpy).

Parity with the reference's slam/transform.py:5-107: 4x4 matrix <-> 6-DoF
(x, y, z, roll, pitch, yaw) conversions, pretty printers, and batched point
transformation.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def tmat_to_sixdof(tmat: np.ndarray) -> np.ndarray:
    """(4, 4) -> (6,) [x, y, z, roll, pitch, yaw] (xyz Euler, radians)."""
    tmat = np.asarray(tmat)
    xyz = tmat[:3, 3]
    rpy = Rotation.from_matrix(tmat[:3, :3]).as_euler("xyz")
    return np.concatenate([xyz, rpy])


def sixdof_to_tmat(sixdof: np.ndarray) -> np.ndarray:
    """(6,) [x, y, z, roll, pitch, yaw] -> (4, 4)."""
    sixdof = np.asarray(sixdof, np.float64)
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("xyz", sixdof[3:]).as_matrix()
    T[:3, 3] = sixdof[:3]
    return T


def string_tmat(tmat: np.ndarray, degrees: bool = True) -> str:
    """Human-readable one-liner of a transform (translation + rpy)."""
    s = tmat_to_sixdof(tmat)
    rpy = np.degrees(s[3:]) if degrees else s[3:]
    unit = "deg" if degrees else "rad"
    return (
        f"t=({s[0]:+.3f}, {s[1]:+.3f}, {s[2]:+.3f})m "
        f"rpy=({rpy[0]:+.2f}, {rpy[1]:+.2f}, {rpy[2]:+.2f}){unit}"
    )


def apply_transformation(transformation: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply (4, 4) (or batched (B, 4, 4)) transforms to (N, 3) points."""
    points = np.asarray(points, np.float64)
    hom = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    T = np.asarray(transformation, np.float64)
    if T.ndim == 2:
        return (hom @ T.T)[:, :3]
    return np.einsum("bij,nj->bni", T, hom)[..., :3]
