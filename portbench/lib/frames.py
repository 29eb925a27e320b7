"""The synthetic world of the traffic: a textured ground plane under a sky,
seen by a forward-looking camera 1.6 m above the ground with KITTI's
normalised intrinsics, rendered by ray-plane intersection in numpy.

The same world as the program's synthetic dataset, copied here so that the
traffic stays fixed whatever the program becomes.  Numpy only: it runs in
worker processes that do not load torch.
"""
from __future__ import annotations

import numpy as np

KITTI_NORMALIZED_K = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
SKY_DEPTH = 80.0
CAM_HEIGHT = 1.6


def intrinsics(height: int, width: int) -> np.ndarray:
    K = KITTI_NORMALIZED_K.copy()
    K[0] *= width
    K[1] *= height
    return K


def texture_coeffs(seed: int):
    """Frequencies (15, 2), phases (15,) and octave weights (15,) of the
    ground texture: 3 channels x 5 octaves of sinusoids."""
    rng = np.random.default_rng(seed)
    fxz = np.empty((15, 2), np.float32)
    ph = np.empty((15,), np.float32)
    wt = np.empty((15,), np.float32)
    for i in range(15):
        freq = 0.25 * 1.7 ** (i % 5)
        fxz[i] = rng.normal(size=2) * freq
        ph[i] = rng.uniform(0, 2 * np.pi)
        wt[i] = 1.4 ** -(i % 5)
    return fxz, ph, wt


def _yaw_pose(x: float, z: float, yaw: float) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[0, 3], T[2, 3] = x, z
    return T


def trajectory(kind: str, frames: int, speed: float, seed: int):
    """(frames, 4, 4) world-from-camera poses on the ground plane.

    'curve': a drive with a gently varying yaw rate (0.02 sin(i / 25) plus
    N(0, 0.002) per frame), as the KITTI residential sequences turn."""
    rng = np.random.default_rng(seed)
    poses = []
    if kind != "curve":
        raise ValueError(f"unknown trajectory {kind!r}")
    x = z = yaw = 0.0
    for i in range(frames):
        poses.append(_yaw_pose(x, z, yaw))
        x, z = x + speed * np.sin(yaw), z + speed * np.cos(yaw)
        yaw += 0.02 * np.sin(i / 25.0) + 0.002 * rng.normal()
    return np.stack(poses).astype(np.float32)


def render(poses: np.ndarray, height: int, width: int, texture_seed: int):
    """uint8 images (N, H, W, 3) and float16 depth (N, H, W) of `poses`."""
    K = intrinsics(height, width)
    u, v = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    pix = np.stack([u, v, np.ones_like(u)], -1).astype(np.float32)
    rays = pix @ np.linalg.inv(K[:3, :3]).T
    v = v.astype(np.float32)
    fxz, ph, wt = texture_coeffs(texture_seed)
    sky = np.stack([np.full((height, width), c, np.float32) for c in (0.55, 0.65, 0.8)], -1)
    sky *= (0.8 + 0.2 * (v / max(height - 1, 1)))[..., None]
    images = np.empty((len(poses), height, width, 3), np.uint8)
    depths = np.empty((len(poses), height, width), np.float16)
    for n, pose in enumerate(poses):
        d_world = rays @ pose[:3, :3].T
        dy = d_world[..., 1]
        hits = dy > 1e-6
        s = np.where(hits, CAM_HEIGHT / np.where(hits, dy, 1.0), SKY_DEPTH)
        world = pose[:3, 3][None, None] + s[..., None] * d_world
        args = (world[..., 0:1].astype(np.float32) * fxz[:, 0]
                + world[..., 2:3].astype(np.float32) * fxz[:, 1] + ph)
        tex = (np.sin(args) * wt).reshape(height, width, 3, 5).sum(-1)
        tex -= tex.min()
        tex /= max(tex.max(), 1e-6)
        img = np.where(hits[..., None], 0.15 + 0.7 * tex, sky)
        images[n] = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
        depths[n] = np.clip(s, 0.0, SKY_DEPTH)
    return images, depths


def render_chunk(args):
    poses, height, width, texture_seed = args
    return render(poses, height, width, texture_seed)
