"""Plain float32 view synthesis and the monodepth2 loss, as CL-SLAM trains and
adapts with them: the pose network's (axis-angle, translation) to SE(3),
disparity to depth, backprojection and projection, the bilinear sampler with
border padding, SSIM + L1 reprojection with min-reprojection auto-masking,
edge-aware smoothness and the velocity term.

A frozen copy of the equations, free of anything of the program.  Departures
from monodepth2 shared with the program under test: the projected depth is
clamped at 1e-3 (monodepth2 adds 1e-7), a disparity is floored at 1e-4 when
`max_depth` is None, and the identity tie-break noise (1e-5 * N(0, 1), one
draw per scale broadcast over the batch) comes from a torch.Generator.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

FRAMES = (-1, 0, 1)
_EPS = 1e-7


def held(x: torch.Tensor, storage: str) -> torch.Tensor:
    """x as a program that stores it in `storage` holds it: "float32" (the
    reference), "bf16" or "fp8" (e4m3, one scale a tensor).  The rounding
    has the identity's gradient."""
    if storage == "fp8":
        from portbench.reference.nets import round_fp8

        return round_fp8(x)
    if storage == "bf16":
        return x + (x.to(torch.bfloat16).float() - x).detach()
    if storage != "float32":
        raise ValueError(f"unknown storage {storage!r}")
    return x


def frame(rgb: torch.Tensor, frame_id: int) -> torch.Tensor:
    """Frame `frame_id` of a (B, 3, H, W, 3) stack, as float32 in [0, 1]."""
    img = rgb[:, FRAMES.index(frame_id)]
    return img.float() / 255.0 if img.dtype == torch.uint8 else img.float()


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    angle = torch.sqrt((aa * aa).sum(-1, keepdim=True) + 1e-24)
    axis = aa / (angle + _EPS)
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    C = 1.0 - ca
    x, y, z = axis[..., 0:1, None], axis[..., 1:2, None], axis[..., 2:3, None]
    return torch.cat([
        torch.cat([x * x * C + ca, x * y * C - z * sa, z * x * C + y * sa], -1),
        torch.cat([x * y * C + z * sa, y * y * C + ca, y * z * C - x * sa], -1),
        torch.cat([z * x * C - y * sa, y * z * C + x * sa, z * z * C + ca], -1),
    ], -2)


def transformation_from_parameters(aa: torch.Tensor, t: torch.Tensor, invert: bool) -> torch.Tensor:
    """T(t) @ R, or its inverse R^T @ T(-t)."""
    R = axis_angle_to_matrix(aa)
    B = aa.shape[0]
    Rh = torch.eye(4, dtype=aa.dtype, device=aa.device).repeat(B, 1, 1)
    Th = torch.eye(4, dtype=aa.dtype, device=aa.device).repeat(B, 1, 1)
    if invert:
        Rh = torch.cat([torch.cat([R.transpose(1, 2), Rh[:, :3, 3:]], 2), Rh[:, 3:]], 1)
        Th = torch.cat([torch.cat([Th[:, :3, :3], -t[..., None]], 2), Th[:, 3:]], 1)
        return Rh @ Th
    Rh = torch.cat([torch.cat([R, Rh[:, :3, 3:]], 2), Rh[:, 3:]], 1)
    Th = torch.cat([torch.cat([Th[:, :3, :3], t[..., None]], 2), Th[:, 3:]], 1)
    return Th @ Rh


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: Optional[float]):
    if max_depth is None:
        return min_depth / torch.clamp_min(disp, 1e-4)
    lo, hi = 1.0 / max_depth, 1.0 / min_depth
    return 1.0 / (lo + (hi - lo) * disp)


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if img.shape[1:3] == (h, w):
        return img
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def project(depth: torch.Tensor, K: torch.Tensor, inv_K: torch.Tensor, T: torch.Tensor):
    """Pixel coordinates (B, H, W, 2) in the source camera of each target
    pixel, from its depth (B, H, W, 1)."""
    B, H, W, _ = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones_like(xs).reshape(-1)])
    cam = depth.reshape(B, 1, -1) * (inv_K[:, :3, :3] @ pix)
    points = torch.cat([cam, torch.ones_like(cam[:, :1])], 1)
    P = (K @ T)[:, :3]
    p = P @ points
    xy = p[:, :2] / torch.clamp_min(p[:, 2:3], 1e-3)
    return xy.reshape(B, 2, H, W).permute(0, 2, 3, 1)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid_sample(bilinear, border, align_corners=True) in pixel units:
    img (B, H, W, C), coords (B, H, W, 2) (x, y)."""
    B, H, W, C = img.shape
    x = torch.minimum(torch.maximum(coords[..., 0], coords.new_zeros(())),
                      coords.new_full((), W - 1))
    y = torch.minimum(torch.maximum(coords[..., 1], coords.new_zeros(())),
                      coords.new_full((), H - 1))
    x0 = torch.clamp_max(torch.floor(x), W - 2).detach()
    y0 = torch.clamp_max(torch.floor(y), H - 2).detach()
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = img.reshape(B, H * W, C)
    base = (y0 * W + x0).long().reshape(B, -1)

    def tap(offset):
        idx = (base + offset)[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(coords.shape[:-1] + (C,))

    top = tap(0) * (1 - wx) + tap(1) * wx
    bottom = tap(W) * (1 - wx) + tap(W + 1) * wx
    return top * (1 - wy) + bottom * wy


def _pad(x: torch.Tensor) -> torch.Tensor:
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], 1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], 2)


def _pool3(x: torch.Tensor) -> torch.Tensor:
    x = (x[:, :-2] + x[:, 1:-1] + x[:, 2:]) / 3.0
    return (x[:, :, :-2] + x[:, :, 1:-1] + x[:, :, 2:]) / 3.0


def reprojection(pred: torch.Tensor, target: torch.Tensor,
                 storage: str = "float32") -> torch.Tensor:
    """0.85 * SSIM distance + 0.15 * L1, channel mean -> (B, H, W).  With
    `storage` below float32 the prediction and the SSIM terms of it alone
    (its pools, its square and theirs) are held in that type, as a program
    that stores the warped image so computes them."""
    def h(v):
        return held(v, storage)

    pred = h(pred)
    x, y = _pad(pred), _pad(target)
    mx, my = h(_pool3(x)), _pool3(y)
    sx = h(h(_pool3(h(x * x))) - h(mx * mx))
    sy, sxy = _pool3(y * y) - my * my, _pool3(x * y) - mx * my
    n = (2 * mx * my + 0.01 ** 2) * (2 * sxy + 0.03 ** 2)
    d = (mx * mx + my * my + 0.01 ** 2) * (sx + sy + 0.03 ** 2)
    ssim = torch.clamp((1 - n / d) / 2, 0, 1)
    return 0.85 * ssim.mean(-1) + 0.15 * (target - pred).abs().mean(-1)


def smoothness(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    d = disp[..., 0]
    d = d / (d.mean((1, 2), keepdim=True) + 1e-7)
    gx = (d[:, :, :-1] - d[:, :, 1:]).abs() * torch.exp(
        -(img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1))
    gy = (d[:, :-1] - d[:, 1:]).abs() * torch.exp(-(img[:, :-1] - img[:, 1:]).abs().mean(-1))
    return gx.mean((1, 2)) + gy.mean((1, 2))


def view_synthesis_loss(disps: Dict[int, torch.Tensor], aa: torch.Tensor, tr: torch.Tensor,
                        rgb: torch.Tensor, K: torch.Tensor, rel_dist: torch.Tensor,
                        weights: torch.Tensor, scales: Sequence[int], min_depth: float,
                        max_depth: Optional[float], smoothness_weight: float,
                        velocity_weight: Optional[float],
                        rng: Optional[torch.Generator] = None, warp_storage: str = "float32"):
    """The monodepth2 loss of one batch.  `disps`: {scale: (B, Hs, Ws, 1)};
    `aa`, `tr`: (2B, 3) for the pairs (-1, 0) then (0, +1); `rgb` (B, 3, H,
    W, 3); `weights` (B,) per-sample weights; `warp_storage` the type the
    warped images are held in (`reprojection`).  Returns (losses, T_next
    (B, 4, 4)): losses holds depth_loss, velocity_loss and loss."""
    B, _, H, W, _ = rgb.shape
    inv_K = torch.linalg.inv(K)
    T = {-1: transformation_from_parameters(aa[:B], tr[:B], True),
         1: transformation_from_parameters(aa[B:], tr[B:], False)}
    target, srcs = frame(rgb, 0), {f: frame(rgb, f) for f in (-1, 1)}
    identity = torch.stack([reprojection(srcs[f], target) for f in (-1, 1)], 1)
    noise = None
    if rng is not None:
        noise = 1e-5 * torch.randn((len(scales), 1) + tuple(identity.shape[1:]), generator=rng,
                                   dtype=identity.dtype, device=identity.device)
    pyramid = [target]
    for _ in scales[1:]:
        p = pyramid[-1]
        pyramid.append(p.reshape(B, p.shape[1] // 2, 2, p.shape[2] // 2, 2, 3).mean((2, 4)))
    total = target.new_zeros(())
    for si, s in enumerate(scales):
        depth = disp_to_depth(resize_bilinear(disps[s], H, W), min_depth, max_depth)
        reproj = torch.stack([
            reprojection(bilinear_sample(srcs[f], project(depth, K, inv_K, T[f])), target,
                         warp_storage)
            for f in (-1, 1)], 1)
        ident = identity if noise is None else identity + noise[si]
        best = torch.cat([ident, reproj], 1).min(1).values
        reproj_l = (best.mean((1, 2)) * weights).sum()
        smooth_l = (smoothness(disps[s], pyramid[si]) * weights).sum()
        total = total + reproj_l + smoothness_weight / 2 ** s * smooth_l
    depth_loss = total / len(scales)
    losses = {"depth_loss": depth_loss, "velocity_loss": depth_loss.new_zeros(())}
    loss = depth_loss
    if velocity_weight is not None and velocity_weight > 0:
        vel = ((torch.linalg.vector_norm(tr[:B], dim=-1) - rel_dist[:, 0].abs()).abs()
               + (torch.linalg.vector_norm(tr[B:], dim=-1) - rel_dist[:, 1].abs()).abs()) / 2
        losses["velocity_loss"] = velocity_weight * (vel * weights).sum()
        loss = loss + losses["velocity_loss"]
    losses["loss"] = loss
    return losses, T[1]
