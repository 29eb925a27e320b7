"""Point-cloud utilities (reference slam/utils.py:25-82 equivalents).

Counterpart of `tpuslam/viz/pointcloud.py` (numpy).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from tpuslam_torch.viz.meshlab import MeshlabExporter


def depth_to_pcl(
    depth: np.ndarray,
    inv_K: np.ndarray,
    image: Optional[np.ndarray] = None,
    dist_threshold: float = np.inf,
) -> np.ndarray:
    """Depth map (H, W) + inverse intrinsics -> (N, 3) or colored (N, 6)."""
    H, W = depth.shape
    xs, ys = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)], axis=0)
    cam = (np.asarray(inv_K)[:3, :3] @ pix) * depth.reshape(1, -1)
    pcl = cam.T
    if image is not None:
        pcl = np.concatenate([pcl, np.asarray(image).reshape(-1, 3)], axis=1)
    if np.isfinite(dist_threshold):
        keep = np.linalg.norm(pcl[:, :3], axis=1) < dist_threshold
        pcl = pcl[keep]
    return pcl


def accumulate_pcl(
    pcl_list: List[np.ndarray], global_poses: np.ndarray
) -> np.ndarray:
    """Transform per-frame clouds into the world frame and concatenate."""
    out = []
    for pcl, T in zip(pcl_list, global_poses):
        hom = np.c_[pcl[:, :3], np.ones(len(pcl))]
        world = (hom @ np.asarray(T).T)[:, :3]
        out.append(np.c_[world, pcl[:, 3:]] if pcl.shape[1] > 3 else world)
    return np.concatenate(out)


def save_point_cloud(
    filename: Union[str, Path],
    pcl: Union[np.ndarray, List[np.ndarray]],
    global_poses: Optional[np.ndarray] = None,
    verbose: bool = True,
) -> Path:
    if global_poses is not None:
        pcl = accumulate_pcl(list(pcl), global_poses)
    exporter = MeshlabExporter()
    exporter.add_points(pcl)
    return exporter.write(filename, verbose=verbose)


def pcl_to_image(
    pcl: np.ndarray, camera_matrix: np.ndarray, image_shape: Tuple[int, int]
) -> np.ndarray:
    """Z-buffered projection of a colored cloud back into an image."""
    H, W = image_shape
    K = np.asarray(camera_matrix)[:3, :3]
    pts = pcl[:, :3]
    valid = pts[:, 2] > 1e-6
    pts = pts[valid]
    colors = pcl[valid, 3:] if pcl.shape[1] > 3 else np.ones((valid.sum(), 3))
    proj = (K @ pts.T).T
    uv = proj[:, :2] / proj[:, 2:3]
    u = np.floor(uv[:, 0]).astype(int)
    v = np.floor(uv[:, 1]).astype(int)
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v = u[inside], v[inside]
    dist = np.linalg.norm(pts[inside], axis=1)
    colors = colors[inside]
    image = np.zeros((H, W, 3))
    zbuf = np.full((H, W), np.inf)
    # z-buffer: draw far-to-near so the nearest point wins
    order = np.argsort(-dist)
    image[v[order], u[order]] = colors[order]
    zbuf[v[order], u[order]] = dist[order]
    return image
