"""Pose graph: pose and point vertices, relative-pose and pose-point edges,
and the solve.

Counterpart of `tpuslam/posegraph/graph.py::PoseGraph`, the public surface
of the reference's g2o wrapper.  `optimize` solves with the float64 LM of
`posegraph/lm.py` on a torch device ("torch"), with the C++ solver of
`native/posegraph.cc` ("native", pose-only), or with native where it builds
and the graph has no points ("auto").
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch import resolve_device, tracing
from tpuslam_torch.posegraph import native
from tpuslam_torch.posegraph.lm import GraphArrays, lm_optimize


class PoseGraph:
    def __init__(self):
        self._poses: Dict[int, np.ndarray] = {}
        self._fixed: Dict[int, bool] = {}
        self._edges: List[Tuple[int, int]] = []
        self._measurements: List[np.ndarray] = []
        self._information: List[np.ndarray] = []
        # point landmarks (g2o's VertexPointXYZ / EdgeSE3PointXYZ)
        self._points: Dict[int, np.ndarray] = {}
        self._point_fixed: Dict[int, bool] = {}
        self._pp_edges: List[Tuple[int, int]] = []  # (pose id, point id)
        self._pp_measurements: List[np.ndarray] = []
        self._pp_information: List[np.ndarray] = []
        self.edge_vertices = set()
        self.num_loop_closures = 0
        self.last_backend: Optional[str] = None  # the backend of the last solve

    def __str__(self) -> str:
        return (
            f"Vertices: {len(self.vertex_ids)}\n"
            f"Edges:   {len(self.edge_vertices)}\n"
            f"Loops:   {self.num_loop_closures}"
        )

    def __len__(self) -> int:
        return len(self._poses)

    @property
    def vertex_ids(self) -> List[int]:
        return sorted(self._poses)

    @property
    def point_ids(self) -> List[int]:
        return sorted(self._points)

    # ------------------------------------------------------------- building
    def add_vertex(self, vertex_id: int, pose: np.ndarray, fixed: bool = False):
        if vertex_id in self._points:
            raise KeyError(f"id {vertex_id} already names a point vertex")
        self._poses[vertex_id] = np.asarray(pose, np.float64).reshape(4, 4).copy()
        self._fixed[vertex_id] = bool(fixed)

    def add_edge(
        self,
        vertices: Tuple[int, int],
        measurement: np.ndarray,
        information: Optional[np.ndarray] = None,
        is_loop_closure: bool = False,
    ):
        """Relative-pose constraint: `measurement` maps vertex j into vertex
        i's frame (X_i^-1 X_j ~ Z), with a 6x6 information weight."""
        i, j = vertices
        if i not in self._poses or j not in self._poses:
            raise KeyError(f"edge references unknown vertex: {vertices}")
        self.edge_vertices.add((i, j))
        if is_loop_closure:
            self.num_loop_closures += 1
        self._edges.append((i, j))
        self._measurements.append(np.asarray(measurement, np.float64).reshape(4, 4).copy())
        self._information.append(
            np.eye(6) if information is None else np.asarray(information, np.float64).copy()
        )

    def add_vertex_point(self, vertex_id: int, point: np.ndarray, fixed: bool = False):
        """XYZ landmark vertex; ids share one namespace with pose vertices."""
        if vertex_id in self._poses:
            raise KeyError(f"id {vertex_id} already names a pose vertex")
        self._points[vertex_id] = np.asarray(point, np.float64).reshape(3).copy()
        self._point_fixed[vertex_id] = bool(fixed)

    def add_edge_pose_point(
        self,
        vertex_pose: int,
        vertex_point: int,
        measurement: np.ndarray,
        information: Optional[np.ndarray] = None,
    ):
        """Pose -> point observation: `measurement` is the point's position
        in the pose frame, with a 3x3 information weight."""
        if vertex_pose not in self._poses:
            raise KeyError(f"edge references unknown pose vertex {vertex_pose}")
        if vertex_point not in self._points:
            raise KeyError(f"edge references unknown point vertex {vertex_point}")
        self._pp_edges.append((vertex_pose, vertex_point))
        self._pp_measurements.append(np.asarray(measurement, np.float64).reshape(3).copy())
        self._pp_information.append(
            np.eye(3) if information is None else np.asarray(information, np.float64).copy()
        )

    # -------------------------------------------------------------- queries
    def get_pose(self, vertex_id: int) -> np.ndarray:
        return self._poses[vertex_id].copy()

    def get_point(self, vertex_id: int) -> np.ndarray:
        return self._points[vertex_id].copy()

    def get_all_poses(self) -> List[np.ndarray]:
        return [self.get_pose(i) for i in self.vertex_ids]

    def get_all_points(self) -> List[np.ndarray]:
        return [self.get_point(i) for i in self.point_ids]

    def get_transform(self, vertex_id_src: int, vertex_id_dst: int) -> np.ndarray:
        return np.linalg.inv(self._poses[vertex_id_src]) @ self._poses[vertex_id_dst]

    def does_edge_exists(self, a: int, b: int) -> bool:
        return (a, b) in self.edge_vertices or (b, a) in self.edge_vertices

    def is_vertex_in_any_edge(self, vertex_id: int) -> bool:
        return any(vertex_id in e for e in self.edge_vertices)

    def does_vertex_have_only_global_edges(self, vertex_id: int) -> bool:
        if not self.is_vertex_in_any_edge(vertex_id):
            raise KeyError(f"vertex {vertex_id} is in no edge")
        return not any(vertex_id in e and abs(e[0] - e[1]) == 1 for e in self.edge_vertices)

    # ----------------------------------------------------------- optimising
    def _pose_arrays(self):
        """Vertex ids, then poses (N, 4, 4), fixed (N,) with the first
        vertex pinned when none is fixed, and the edges as vertex indices."""
        ids = self.vertex_ids
        idx = {v: k for k, v in enumerate(ids)}
        fixed = np.array([self._fixed[i] for i in ids], bool)
        if not fixed.any():
            fixed[0] = True  # pin the gauge
        edges = np.array([[idx[i], idx[j]] for i, j in self._edges], np.int64).reshape(-1, 2)
        return ids, np.stack([self._poses[i] for i in ids]), fixed, edges

    def to_arrays(self, device="cpu") -> Tuple[GraphArrays, List[int]]:
        """The graph as float64 tensors on `device`, and its vertex ids."""
        ids, poses, fixed, edges = self._pose_arrays()
        idx = {v: k for k, v in enumerate(ids)}
        pids = self.point_ids
        pidx = {v: k for k, v in enumerate(pids)}

        def f64(x, shape):
            return np.stack(x) if len(x) else np.zeros((0,) + shape)

        arrays = dict(
            poses=poses, fixed=fixed, edges=edges,
            measurements=f64(self._measurements, (4, 4)),
            information=f64(self._information, (6, 6)),
            points=f64([self._points[i] for i in pids], (3,)),
            point_fixed=np.array([self._point_fixed[i] for i in pids], bool),
            pp_edges=np.array([[idx[i], pidx[j]] for i, j in self._pp_edges],
                              np.int64).reshape(-1, 2),
            pp_measurements=f64(self._pp_measurements, (3,)),
            pp_information=f64(self._pp_information, (3, 3)),
        )
        device = torch.device(device)
        return GraphArrays(**{
            k: torch.as_tensor(v, dtype=torch.float64 if v.dtype.kind == "f" else None,
                               device=device)
            for k, v in arrays.items()}), ids

    @tracing.traced("pg.optimize")
    def optimize(
        self,
        max_iterations: int = 20,
        verbose: bool = False,
        backend: str = "torch",
        device="cuda",
    ) -> float:
        """Optimise the graph in place and return the final weighted error.

        backend: "torch" (the float64 LM of `posegraph/lm.py` on `device`),
        "native" (the C++ solver, pose-only) or "auto" (native when the
        library builds and the graph has no points, else torch).  Both stop
        early once an accepted step stops reducing the error, so a cap of
        10000 costs only the iterations taken.  The torch backend assembles
        a dense (6N + 3P)^2 H; native exploits the chain's band."""
        if not self._edges:
            return 0.0
        if backend == "auto":
            backend = "native" if not self._points and native.is_available() else "torch"
        if backend not in ("torch", "native"):
            raise ValueError(f"unknown pose-graph backend {backend!r}")
        if backend == "native":
            if self._points:
                raise ValueError("the native backend is pose-only; use backend='torch' "
                                 "or 'auto' for graphs with point landmarks")
            ids, poses, fixed, edges = self._pose_arrays()
            poses, err = native.optimize_native(
                poses, fixed, edges, np.stack(self._measurements),
                np.stack(self._information), max_iterations=max_iterations)
        else:
            g, ids = self.to_arrays(resolve_device(device))
            out, out_points, err = lm_optimize(g, max_iterations=max_iterations)
            poses = out.cpu().numpy()
            pts = out_points.cpu().numpy()
            for k, pid in enumerate(self.point_ids):
                if not self._point_fixed[pid]:
                    self._points[pid] = pts[k]
        for k, vid in enumerate(ids):
            if not self._fixed[vid]:
                self._poses[vid] = poses[k]
        self.last_backend = backend
        if verbose:
            print(f"pose graph optimised [{backend}]: error={err:.6f}")
        return float(err)

    def visualize_in_meshlab(self, filename, meshlab=None, verbose: bool = True):
        """The vertices' positions and an `l` line per edge, as an OBJ file."""
        from tpuslam_torch.viz.meshlab import MeshlabExporter

        if not self.vertex_ids:
            return
        exporter = meshlab if meshlab is not None else MeshlabExporter()
        points = {i: self._poses[i][:3, 3] for i in self.vertex_ids}
        for p in points.values():
            exporter.add_points(p)
        for a, b in self.edge_vertices:
            exporter.add_line(points[a], points[b])
        exporter.write(filename, verbose=verbose)
