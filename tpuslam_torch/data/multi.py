"""Sequential multi-domain dataset: CoVIO's cross-domain deployment.

Counterpart of `tpuslam/data/multi.py` (numpy).

Chains several Sample-yielding datasets back to back (e.g. Cityscapes ->
KITTI -> RobotCar, BASELINE config rung 5) so one SLAM run traverses domain
boundaries; `domain_of(index)` exposes which domain a frame belongs to (e.g.
to trigger `Slam.reset_expert_from_generalist` on transitions).

Global poses are chained so the trajectory stays continuous: each domain's
poses are premultiplied by the previous domain's final pose.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from tpuslam_torch.data.base import Sample


class ChainedDataset:
    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("need at least one dataset")
        self.datasets = list(datasets)
        self._bounds: List[Tuple[int, int]] = []
        start = 0
        for ds in self.datasets:
            self._bounds.append((start, start + len(ds)))
            start += len(ds)
        # chain global poses across domain boundaries
        self._offsets = [np.eye(4)]
        for ds in self.datasets[:-1]:
            last = np.asarray(ds.global_poses[-1], np.float64)
            first_inv = np.linalg.inv(np.asarray(ds.global_poses[0], np.float64))
            self._offsets.append(self._offsets[-1] @ (last @ first_inv))

    def __len__(self) -> int:
        return self._bounds[-1][1]

    def domain_of(self, index: int) -> int:
        for d, (lo, hi) in enumerate(self._bounds):
            if lo <= index < hi:
                return d
        raise IndexError(index)

    @property
    def global_poses(self):
        # exposed for Slam's first-vertex convention; domain 0's poses lead
        return self.datasets[0].global_poses

    def __getitem__(self, index: int) -> Sample:
        d = self.domain_of(index)
        lo, _ = self._bounds[d]
        s = self.datasets[d][index - lo]
        offset = self._offsets[d]
        rel_pose = s.rel_pose
        abs_pose = (
            None if s.abs_pose is None else (offset @ np.asarray(s.abs_pose, np.float64)).astype(np.float32)
        )
        return Sample(
            index=index,
            rgb=s.rgb,
            rgb_aug=s.rgb_aug,
            K=s.K,
            rel_dist=s.rel_dist,
            rel_pose=rel_pose,
            abs_pose=abs_pose,
            depth=s.depth,
            mask=s.mask,
            filenames=s.filenames,
        )
