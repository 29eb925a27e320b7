"""Camera geometry and image resampling on torch tensors (NHWC images).

Counterpart of `tpuslam/geometry/camera.py`.  The samplers keep the corner
conventions of the reference ops:

* `bilinear_sampler` == F.grid_sample(mode='bilinear', padding_mode='border',
                        align_corners=True), in pixel units
* `resize_bilinear`  == F.interpolate(mode='bilinear', align_corners=False)
* `resize_nearest`   == F.interpolate(mode='nearest')

All geometry runs in float32 with TF32 off (see `tpuslam_torch.full_fp32`):
a lower-precision matmul moves the warp coordinates by ~0.1 px.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pixel_grid(height: int, width: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Homogeneous pixel grid (3, H*W): rows are (x, y, 1)."""
    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    ones = torch.ones(height * width, dtype=dtype, device=device)
    return torch.stack([gx.reshape(-1), gy.reshape(-1), ones], dim=0)


def backproject_depth(depth: torch.Tensor, inv_K: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Depth (B, H, W[, 1]) -> homogeneous camera-frame points (B, 4, H*W).

    Only the top-left 3x3 of `inv_K` (B, 4, 4) is used; `pix` comes from
    `pixel_grid`.
    """
    B = depth.shape[0]
    d = depth.reshape(B, 1, -1)
    cam = d * torch.matmul(inv_K[:, :3, :3], pix[None])  # (B, 3, HW)
    ones = cam.new_ones((B, 1, cam.shape[-1]))
    return torch.cat([cam, ones], dim=1)


def project_3d(
    points: torch.Tensor,
    K: torch.Tensor,
    T: torch.Tensor,
    height: int,
    width: int,
    eps: float = 1e-3,
) -> torch.Tensor:
    """Project (B, 4, H*W) points into pixel coordinates (B, H, W, 2) (x, y)
    of a camera with intrinsics K and pose T (both (B, 4, 4)).

    The depth is clamped at `eps`: the reference's `z + 1e-7` gives ~1/z^2
    gradients for points behind the camera, the NaN path of aggressive
    adaptation; max(z, eps) leaves valid points unchanged.
    """
    P = torch.matmul(K, T)[:, :3, :]
    cam = torch.matmul(P, points)  # (B, 3, HW)
    z = torch.clamp_min(cam[:, 2:3, :], eps)
    xy = cam[:, :2, :] / z
    return xy.reshape(points.shape[0], 2, height, width).permute(0, 2, 3, 1)


def projection_affine(K: torch.Tensor, inv_K: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """`backproject_depth` + `project_3d` collapsed into one affine camera
    map per sample, (B, 12): with P = (K @ T)[:3] and A = P[:, :3] @
    inv_K[:3, :3], columns 0-8 hold A row-major and 9-11 hold P[:, 3], so
    that cam = d * A @ (u, v, 1) + P[:, 3] before the z-clamped divide.  The
    operand of the in-kernel-projection warp (K5, `ops/warp.py`)."""
    P = torch.matmul(K, T)[:, :3, :]  # (B, 3, 4)
    A = torch.matmul(P[:, :, :3], inv_K[:, :3, :3])
    return torch.cat([A.reshape(K.shape[0], 9), P[:, :, 3]], dim=1)


def _clip(v: torch.Tensor, hi: float) -> torch.Tensor:
    # maximum/minimum rather than clamp: at an exact tie they pass half the
    # gradient, like jnp.clip, which gives the 0.5 edge subgradient of the
    # reference sampler
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_full((), hi))


def bilinear_taps(
    img: torch.Tensor, coords: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """The four bilinear taps and weights of `bilinear_sampler`.

    Returns (a0, a1, b0, b1, wx, wy): a0/a1 are the top-left/top-right
    source pixels (B, Ho, Wo, C), b0/b1 the bottom ones, and wx/wy
    (B, Ho, Wo, 1) the weights.  Coordinates clamp to [0, W-1] x [0, H-1]
    and the floors to W-2 / H-2, so the border texel carries the whole
    weight at the edge (grid_sample's border padding).  Differentiable in
    `coords` through wx, wy.
    """
    B, H, W, C = img.shape
    x = _clip(coords[..., 0], W - 1)
    y = _clip(coords[..., 1], H - 1)
    x0 = torch.clamp_max(torch.floor(x), W - 2).detach()
    y0 = torch.clamp_max(torch.floor(y), H - 2).detach()
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    flat = img.reshape(B, H * W, C)
    base = (y0 * W + x0).long().reshape(B, -1)

    def tap(offset):
        idx = (base + offset)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(coords.shape[:-1] + (C,))

    return tap(0), tap(1), tap(W), tap(W + 1), wx, wy


def bilinear_blend(a0, a1, b0, b1, wx, wy) -> torch.Tensor:
    """Interpolate the taps of `bilinear_taps`: rows in x, then y."""
    top = a0 * (1 - wx) + a1 * wx
    bot = b0 * (1 - wx) + b1 * wx
    return top * (1 - wy) + bot * wy


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with border padding (grid_sample parity).

    img (B, H, W, C); coords (B, Ho, Wo, 2) in pixel units (x, y) of the
    source image -> (B, Ho, Wo, C).  This is the plain version of the warp
    kernel in `tpuslam_torch.ops.warp` without taps.
    """
    return bilinear_blend(*bilinear_taps(img, coords))


def resize_bilinear(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC bilinear resize, half-pixel centres (align_corners=False)."""
    if img.shape[1:3] == (height, width):
        return img
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(height, width),
                        mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1)


def resize_nearest(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """NHWC nearest resize: source index floor(dst * in / out)."""
    if img.shape[1:3] == (height, width):
        return img
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(height, width), mode="nearest")
    return out.permute(0, 2, 3, 1)


def scale_camera_matrix(camera_matrix, height: int, width: int):
    """Normalised intrinsics -> (pixel intrinsics at (height, width), inverse).

    The stored matrix has fx, cx in units of image width and fy, cy in
    units of image height.
    """
    K = torch.as_tensor(camera_matrix, dtype=torch.float32).clone()
    K[0, :] *= width
    K[1, :] *= height
    return K, torch.linalg.inv(K)
