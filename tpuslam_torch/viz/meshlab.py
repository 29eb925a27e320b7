"""Wavefront OBJ export for point clouds / trajectories / pose graphs.

Counterpart of `tpuslam/viz/meshlab.py` (numpy and scipy).

Functional equivalent of the reference's MeshlabInf writer
(slam/meshlab.py:14-206): accumulate colored points and line
segments, write a single OBJ consumable by MeshLab.  Lines are emitted as
OBJ `l` elements (polyline) instead of degenerate faces.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np


class MeshlabExporter:
    def __init__(self):
        self._points: List[np.ndarray] = []  # (N, 6) xyz + rgb
        self._lines: List[np.ndarray] = []  # (2, 3) segment endpoints
        self._faces: List[List[int]] = []  # 0-based indices into the points

    def _num_points(self) -> int:
        return sum(len(b) for b in self._points)

    def clear(self) -> None:
        """Drop all accumulated geometry (reference MeshlabInf.clear)."""
        self._points.clear()
        self._lines.clear()
        self._faces.clear()

    def add_points(
        self, points: np.ndarray, color: Optional[np.ndarray] = None
    ) -> None:
        """points: (3,) or (N, 3) or (N, 6) with per-point RGB in [0, 1]."""
        pts = np.atleast_2d(np.asarray(points, np.float64))
        if pts.shape[1] == 3:
            c = np.ones((len(pts), 3)) if color is None else np.atleast_2d(color)
            c = np.broadcast_to(c, (len(pts), 3))
            pts = np.concatenate([pts, c], axis=1)
        elif pts.shape[1] != 6:
            raise ValueError("points must be (N, 3) or (N, 6)")
        self._points.append(pts)

    def add_line(self, start: np.ndarray, end: np.ndarray) -> None:
        self._lines.append(
            np.stack([np.asarray(start, np.float64), np.asarray(end, np.float64)])
        )

    def add_camera(
        self, position: np.ndarray, rotation: Optional[np.ndarray] = None, size: float = 0.5
    ) -> None:
        """Draw a small camera frustum (4 lines from apex to image corners)."""
        pos = np.asarray(position, np.float64)
        R = np.eye(3) if rotation is None else np.asarray(rotation, np.float64)
        corners = (
            np.array(
                [[-1, -0.6, 1.5], [1, -0.6, 1.5], [1, 0.6, 1.5], [-1, 0.6, 1.5]]
            )
            * size
        )
        world = corners @ R.T + pos
        for c in world:
            self.add_line(pos, c)
        for a, b in zip(world, np.roll(world, 1, axis=0)):
            self.add_line(a, b)

    def add_mesh(self, grid: np.ndarray, color: Optional[np.ndarray] = None) -> None:
        """Triangulated surface from an (M, N, 3) vertex grid — two triangles
        per quad; NaN vertices (and any face touching one) are dropped.
        Reference MeshlabInf.add_mesh (slam/meshlab.py:79-114), vectorised.

        color: None (white), (M, N) grayscale, or (M, N, 3) RGB in [0, 1].
        """
        xyz = np.asarray(grid, np.float64)
        if xyz.ndim != 3 or xyz.shape[2] != 3:
            raise ValueError("grid must be (M, N, 3)")
        M, N = xyz.shape[:2]
        if color is None:
            col = np.ones((M, N, 3))
        else:
            col = np.asarray(color, np.float64)
            if col.ndim == 2:
                col = np.repeat(col[..., None], 3, axis=2)
            if col.shape != (M, N, 3):
                raise ValueError("color must be (M, N) or (M, N, 3)")
        flat = xyz.reshape(-1, 3)
        cflat = col.reshape(-1, 3)
        idx = np.arange(M * N).reshape(M, N)
        ul = idx[:-1, :-1].ravel()
        ur = idx[:-1, 1:].ravel()
        ll = idx[1:, :-1].ravel()
        lr = idx[1:, 1:].ravel()
        tris = np.concatenate(
            [np.stack([ur, ul, ll], 1), np.stack([ll, lr, ur], 1)], axis=0
        )
        ok = np.all(np.isfinite(flat), axis=1)
        tris = tris[ok[tris].all(axis=1)]
        remap = np.cumsum(ok) - 1  # compact indices over the kept vertices
        tris = remap[tris]
        base = self._num_points()
        self.add_points(np.concatenate([flat[ok], cflat[ok]], axis=1))
        self._faces.extend((tris + base).tolist())

    def add_polygon(self, xyz: np.ndarray, color: Optional[np.ndarray] = None) -> None:
        """One filled polygon over the given (N, 3) vertices (reference
        add_pgon, slam/meshlab.py:141-145); NaN vertices dropped."""
        xyz = np.atleast_2d(np.asarray(xyz, np.float64))
        xyz = xyz[np.all(np.isfinite(xyz), axis=1)]
        base = self._num_points()
        self.add_points(xyz, color=color)
        self._faces.append(list(range(base, base + len(xyz))))

    def write(self, filename: Union[str, Path], verbose: bool = True) -> Path:
        path = Path(filename)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            f.write("# tpuslam OBJ export\n")
            for block in self._points:
                for x, y, z, r, g, b in block:
                    f.write(f"v {x:.6f} {y:.6f} {z:.6f} {r:.4f} {g:.4f} {b:.4f}\n")
            for face in self._faces:
                f.write("f " + " ".join(str(i + 1) for i in face) + "\n")
            base = self._num_points()
            for k, seg in enumerate(self._lines):
                for x, y, z in seg:
                    f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
                a = base + 2 * k + 1
                f.write(f"l {a} {a + 1}\n")
        if verbose:
            print(f"wrote {path}")
        return path


def norm_range_01(values: np.ndarray) -> np.ndarray:
    """Normalise to [0, 1] (reference meshlab.py:209-229)."""
    values = np.asarray(values, np.float64)
    lo, hi = values.min(), values.max()
    if hi - lo < 1e-12:
        return np.zeros_like(values)
    return (values - lo) / (hi - lo)


def false_color(values: np.ndarray) -> np.ndarray:
    """Map scalars to a simple blue->red colormap -> (N, 3)."""
    t = norm_range_01(values)
    return np.stack([t, 0.2 * np.ones_like(t), 1.0 - t], axis=-1)


def rotation_matrix_from_to(
    v_from: np.ndarray, v_to: np.ndarray, output4x4: bool = False
) -> np.ndarray:
    """Rotation matrix taking direction `v_from` onto `v_to`.

    Reference rotation_matrix_from_to (slam/meshlab.py:232-267) without the
    cv2 dependency (scipy Rodrigues).  The antiparallel case uses a
    deterministic perpendicular axis where the reference draws a random one.
    """
    from scipy.spatial.transform import Rotation

    a = np.asarray(v_from, np.float64).reshape(3)
    b = np.asarray(v_to, np.float64).reshape(3)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)

    axis = np.cross(a, b)
    nrm = np.linalg.norm(axis)
    if np.allclose(a, b, atol=1e-12):
        R = np.eye(3)
    elif nrm < 1e-12:  # antiparallel: rotate pi around any perpendicular
        helper = np.zeros(3)
        helper[np.argmin(np.abs(a))] = 1.0
        axis = helper - (a @ helper) * a
        axis = axis / np.linalg.norm(axis)
        R = Rotation.from_rotvec(axis * np.pi).as_matrix()
    else:
        angle = np.arccos(np.clip(a @ b, -1.0, 1.0))
        R = Rotation.from_rotvec(axis / nrm * angle).as_matrix()
    if output4x4:
        out = np.eye(4)
        out[:3, :3] = R
        return out
    return R
