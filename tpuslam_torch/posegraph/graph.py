"""Pose graph container: vertices and relative-pose edges.

The building and query surface of `tpuslam/posegraph/graph.py::PoseGraph`.
The solve (`optimize`) comes with loop closure, in a later part of the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class PoseGraph:
    def __init__(self):
        self._poses: Dict[int, np.ndarray] = {}
        self._fixed: Dict[int, bool] = {}
        self._edges: List[Tuple[int, int]] = []
        self._measurements: List[np.ndarray] = []
        self._information: List[np.ndarray] = []
        self.num_loop_closures = 0

    def __len__(self) -> int:
        return len(self._poses)

    @property
    def vertex_ids(self) -> List[int]:
        return sorted(self._poses)

    def add_vertex(self, vertex_id: int, pose: np.ndarray, fixed: bool = False):
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
        if is_loop_closure:
            self.num_loop_closures += 1
        self._edges.append((i, j))
        self._measurements.append(np.asarray(measurement, np.float64).reshape(4, 4).copy())
        self._information.append(
            np.eye(6) if information is None else np.asarray(information, np.float64).copy()
        )

    def get_pose(self, vertex_id: int) -> np.ndarray:
        return self._poses[vertex_id].copy()

    def get_all_poses(self) -> List[np.ndarray]:
        return [self.get_pose(i) for i in self.vertex_ids]
