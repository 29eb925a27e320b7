"""The datasets the benchmark hands the program: frames rendered once in
set-up, served from host memory.

`DriveStream` is a camera stream for `Slam`: sample i is the triplet of
frames (i, i + 1, i + 2) with the ground truth of the program's sample
contract.  Past the rendered frames it starts again from the first, so that
a faster program never runs out of frames.  `TripletPool` is a pretraining
split: `length` samples cycling over the rendered triplets, each colour
jittered and flipped on access by the program's own augmentation, as its
Cityscapes loader does.
"""
from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from portbench.lib import frames


def render_parallel(poses: np.ndarray, height: int, width: int, texture_seed: int,
                    workers: int):
    """Render `poses` in `workers` processes (numpy only); uint8 images and
    float16 depths in pose order."""
    workers = max(1, min(workers, len(poses), os.cpu_count() or 1))
    chunks = np.array_split(np.arange(len(poses)), workers * 2)
    jobs = [(poses[c], height, width, texture_seed) for c in chunks if len(c)]
    if workers == 1:
        parts = [frames.render_chunk(j) for j in jobs]
    else:
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
            parts = list(pool.map(frames.render_chunk, jobs))
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


class DriveStream:
    def __init__(self, poses: np.ndarray, images: np.ndarray, depths: np.ndarray):
        from tpuslam_torch.data.base import Sample

        self._sample = Sample
        self.global_poses = poses
        self.images, self.depths = images, depths
        self.K = frames.intrinsics(images.shape[1], images.shape[2])
        # distance from the frame before, the last rendered frame before the first
        pos = poses[:, :3, 3]
        self._dist = np.linalg.norm(pos - np.roll(pos, 1, axis=0), axis=1).astype(np.float32)
        self.rendered = len(images)

    def __len__(self) -> int:
        return 10 ** 9

    def _at(self, p: int) -> int:
        return p % self.rendered

    def rgb(self, index: int) -> np.ndarray:
        """The (3, H, W, 3) uint8 triplet of sample `index`."""
        return self.images[[self._at(index + k) for k in range(3)]]

    def __getitem__(self, index: int):
        if index < 0:
            raise IndexError(index)
        c = index + 1
        pc, pn = self.global_poses[self._at(c)], self.global_poses[self._at(c + 1)]
        return self._sample(
            index=index,
            rgb=self.rgb(index).astype(np.float32) / 255.0,
            K=self.K,
            rel_dist=np.array([self._dist[self._at(c)], self._dist[self._at(c + 1)]], np.float32),
            rel_pose=(np.linalg.inv(pc) @ pn).astype(np.float32),
            abs_pose=pn.astype(np.float32),
            depth=self.depths[self._at(c)].astype(np.float32),
        )


class TripletPool:
    def __init__(self, poses: np.ndarray, images: np.ndarray, length: int, seed: int,
                 flip: float):
        from tpuslam_torch.data import base

        self._sample, self._flip, self._jitter = (base.Sample, base.flip_sample_arrays,
                                                  base.random_color_jitter)
        self.images, self.length, self.flip = images, length, flip
        self.triplets = len(images) - 2
        self.K = frames.intrinsics(images.shape[1], images.shape[2])
        steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
        self._dist = np.concatenate([[0.0], steps]).astype(np.float32)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        if not 0 <= index < self.length:
            raise IndexError(index)
        t = index % self.triplets
        rgb = self.images[t:t + 3].astype(np.float32) / 255.0
        jitter = self._jitter(self.rng)
        flip = self.rng.random() < self.flip
        rgb_aug = np.stack([jitter(f) for f in rgb])
        if flip:
            rgb, rgb_aug, _ = self._flip(rgb, rgb_aug)
        return self._sample(index=index, rgb=rgb, rgb_aug=rgb_aug, K=self.K,
                            rel_dist=self._dist[t + 1:t + 3].copy())
