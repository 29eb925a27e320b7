"""Procedural synthetic driving sequence with exact ground truth.

A hermetic stand-in for KITTI (the reference has no test fixtures at all —
SURVEY.md §4): an analytically rendered world (textured ground plane + sky)
seen from a camera driving a configurable trajectory.  Every frame comes with
exact depth, global pose, relative pose and velocity, so the full SLAM loop —
adaptation, replay buffer, loop closures (circular trajectories revisit their
start), pose-graph optimisation, trajectory/depth metrics — runs end-to-end
with no downloads.

Rendering is pure numpy ray-plane intersection; the plane texture is an
infinite C-inf sum of sinusoids, so photometric gradients exist everywhere
(needed for the self-supervised loss to be informative).
"""
from __future__ import annotations

import threading
import zlib
from typing import Tuple

import numpy as np

from tpuslam_torch.data.base import (
    KITTI_NORMALIZED_K,
    Sample,
    random_color_jitter,
    scale_intrinsics,
)

_SKY_DEPTH = 80.0
_CAM_HEIGHT = 1.6  # meters above the ground plane


def _texture_coeffs(seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(15, 2) frequencies, (15,) phases, (15,) octave weights — same draw
    order as the original per-channel/per-octave loop (3 channels x 5
    octaves), so a given seed keeps its world."""
    rng = np.random.default_rng(seed)
    fxz = np.empty((15, 2), np.float32)
    ph = np.empty((15,), np.float32)
    wt = np.empty((15,), np.float32)
    i = 0
    for _c in range(3):
        for octave in range(5):
            freq = 0.25 * (1.7**octave)
            fxz[i] = rng.normal(size=2) * freq
            ph[i] = rng.uniform(0, 2 * np.pi)
            wt[i] = 1.4**-octave
            i += 1
    return fxz, ph, wt


def _texture(x: np.ndarray, z: np.ndarray, seed: int) -> np.ndarray:
    """Smooth infinite RGB texture: sum of random sinusoids over (x, z).

    One vectorised f32 `np.sin` over all 15 (channel, octave) sinusoids —
    the scalar-coefficient form promoted everything to float64 and was the
    dominant host-feed cost (15 separate full-image f64 sin passes,
    ~3/4 of profile_host_pipeline's ms_decode at 192x640)."""
    fxz, ph, wt = _texture_coeffs(seed)
    x = np.asarray(x, np.float32)
    z = np.asarray(z, np.float32)
    args = x[..., None] * fxz[:, 0] + z[..., None] * fxz[:, 1] + ph  # (H, W, 15)
    out = (np.sin(args) * wt).reshape(x.shape + (3, 5)).sum(axis=-1)
    out -= out.min()
    out /= max(out.max(), 1e-6)
    return (0.15 + 0.7 * out).astype(np.float32)


def make_trajectory(
    num_frames: int,
    kind: str = "curve",
    speed: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """(N, 4, 4) world-from-camera poses.

    kind: 'straight' (constant forward), 'curve' (gentle sinusoidal yaw),
    'loop' (closed circle — revisits its start for loop-closure tests).
    """
    rng = np.random.default_rng(seed)
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    if kind == "loop":
        # exact circle: N steps of arc length `speed`
        radius = speed * num_frames / (2 * np.pi)
        dyaw = 2 * np.pi / num_frames
    for i in range(num_frames):
        if kind == "curve":
            dyaw = 0.02 * np.sin(i / 25.0) + 0.002 * rng.normal()
        elif kind == "straight":
            dyaw = 0.0
        R = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ],
            np.float32,
        )
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T)
        forward = R @ np.array([0.0, 0.0, 1.0])
        pos = pos + speed * forward
        yaw += dyaw
    return np.stack(poses)


def _lidar_beam_mask(H: int, W: int, seed: int) -> np.ndarray:
    """64-beam projected-scan validity pattern, fixed per dataset.

    Mimics the projected velodyne gt of real KITTI depth maps: beams land
    on rows from just below the horizon to the image bottom (denser near
    the horizon, like equal-angle beams projected on the ground plane),
    each hit along ~55% of columns — overall ~5-8% valid pixels."""
    rng = np.random.default_rng(seed + 97)
    mask = np.zeros((H, W), bool)
    horizon = int(H * 0.45)
    # beam rows can collide after projection; cap at every-other-row so
    # the overall density lands at real KITTI's ~5-9% valid pixels
    beams = min(64, (H - 1 - horizon) // 2)
    for b in range(beams):
        frac = (b / max(beams - 1, 1)) ** 1.5
        r = min(horizon + int(frac * (H - 1 - horizon)), H - 1)
        mask[r, rng.random(W) < 0.35] = True
    return mask


class SyntheticDataset:
    """Drop-in data source with the same sample contract as Kitti."""

    def __init__(
        self,
        num_frames: int = 64,
        height: int = 96,
        width: int = 320,
        trajectory: str = "curve",
        speed: float = 1.0,
        seed: int = 0,
        do_augmentation: bool = False,
        noise: float = 0.0,
        sparse_depth: bool = False,
    ):
        self.height = height
        self.width = width
        self.noise = noise
        self.seed = seed
        self.do_augmentation = do_augmentation
        self.K = scale_intrinsics(KITTI_NORMALIZED_K, height, width)
        # LiDAR-like GT sparsity (KITTI dress rehearsal): real KITTI gt
        # depth is the projected velodyne scan — ~5-8% of pixels valid,
        # below the horizon only, 0 = invalid (datasets/kitti.py depth
        # maps).  A fixed per-dataset beam pattern reproduces that
        # density/row structure so the eval path (calc_depth_error's
        # gt > min_depth mask, median scaling over sparse pixels) is
        # exercised at real sparsity.
        self._depth_mask = (
            _lidar_beam_mask(height, width, seed) if sparse_depth else None
        )
        self.inv_K33 = np.linalg.inv(self.K[:3, :3])
        # one extra pose on each side so every center frame has neighbours
        self.global_poses = make_trajectory(num_frames + 2, trajectory, speed, seed)
        # sequential access renders each frame ~3x (as -1/0/+1 neighbour);
        # a small LRU of rendered frames removes the redundant ray casts
        self._render_cache: dict = {}
        self._ray_grid = None
        self._aug_rng = np.random.default_rng(seed + 1)
        # Slam.run(prefetch_workers > 1) calls __getitem__ concurrently:
        # the shared Generator and the cache's check-evict-insert sequence
        # are not thread-safe on their own.
        self._rng_lock = threading.Lock()
        self._cache_lock = threading.Lock()
        positions = self.global_poses[:, :3, 3]
        steps = np.linalg.norm(np.diff(positions, axis=0), axis=1)
        self.relative_distances = np.concatenate([[0.0], steps]).astype(np.float32)

    def __len__(self) -> int:
        return len(self.global_poses) - 2

    def render(self, pose_wc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Render (H, W, 3) image + (H, W) depth from a world-from-cam pose."""
        H, W = self.height, self.width
        if self._ray_grid is None:
            u, v = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
            pix = np.stack([u, v, np.ones_like(u)], axis=-1).astype(np.float32)
            # pose-independent ray directions (cam frame) — cached
            self._ray_grid = (pix @ self.inv_K33.T, v.astype(np.float32))
        d_cam, v = self._ray_grid
        R, t = pose_wc[:3, :3], pose_wc[:3, 3]
        d_world = d_cam @ R.T
        # camera y stays 0 on the planar trajectory; ground plane at y=+H (y down)
        dy = d_world[..., 1]
        hits = dy > 1e-6  # rays pointing down hit the ground (y grows downward)
        s = np.where(hits, _CAM_HEIGHT / np.where(hits, dy, 1.0), _SKY_DEPTH)
        depth = np.clip(s * 1.0, 0.0, _SKY_DEPTH).astype(np.float32)
        # depth is along-ray scale; z-depth = s * d_cam_z (d_cam_z == 1 here)
        world = t[None, None, :] + s[..., None] * d_world
        img = _texture(world[..., 0], world[..., 2], self.seed)
        sky = np.stack(
            [np.full_like(dy, 0.55), np.full_like(dy, 0.65), np.full_like(dy, 0.8)],
            axis=-1,
        )
        # mild vertical gradient so the sky has photometric texture too
        sky *= (0.8 + 0.2 * (v / max(H - 1, 1)))[..., None]
        img = np.where(hits[..., None], img, sky).astype(np.float32)
        if self.noise > 0:
            # crc32, not hash(): str/bytes hashing is salted per process, so
            # hash() would make renders non-reproducible across runs
            nrng = np.random.default_rng(zlib.crc32(pose_wc.tobytes()))
            img = np.clip(img + nrng.normal(0, self.noise, img.shape), 0, 1).astype(
                np.float32
            )
        return img, depth

    def __getitem__(self, index: int) -> Sample:
        if not 0 <= index < len(self):
            raise IndexError(index)
        center = index + 1
        frames, depth0 = [], None
        for off in (-1, 0, 1):
            key = center + off
            with self._cache_lock:
                cached = self._render_cache.get(key)
            if cached is None:
                # render outside the lock (a racing duplicate render of the
                # same frame is harmless — both produce identical arrays)
                cached = self.render(self.global_poses[key])
                with self._cache_lock:
                    if len(self._render_cache) > 8:
                        self._render_cache.pop(next(iter(self._render_cache)))
                    self._render_cache[key] = cached
            img, depth = cached
            frames.append(img)
            if off == 0:
                depth0 = depth
                if self._depth_mask is not None:
                    depth0 = np.where(self._depth_mask, depth0, 0.0).astype(
                        np.float32
                    )
        rgb = np.stack(frames)
        rgb_aug = None
        if self.do_augmentation:
            with self._rng_lock:  # the draw is cheap; applying it is not
                jitter = random_color_jitter(self._aug_rng)
            rgb_aug = np.stack([jitter(f) for f in frames])
        # reference contract (datasets/kitti.py:306-314): pose of frame +1
        # relative to frame 0, and the global pose of frame +1
        rel_pose = (
            np.linalg.inv(self.global_poses[center]) @ self.global_poses[center + 1]
        ).astype(np.float32)
        return Sample(
            index=index,
            rgb=rgb,
            rgb_aug=rgb_aug,
            K=self.K,
            rel_dist=np.array(
                [
                    self.relative_distances[center],
                    self.relative_distances[center + 1],
                ],
                np.float32,
            ),
            rel_pose=rel_pose,
            abs_pose=self.global_poses[center + 1].astype(np.float32),
            depth=depth0,
            filenames=None,
        )

    def relative_pose(self, index: int) -> np.ndarray:
        """GT pose of frame `index` relative to `index - 1` (world poses)."""
        center = index + 1
        return (
            np.linalg.inv(self.global_poses[center - 1]) @ self.global_poses[center]
        ).astype(np.float32)
