"""Self-supervised photometric losses on NHWC torch tensors.

Counterpart of `tpuslam/losses/photometric.py` (the monodepth2 loss stack):
per-frame SSIM + L1 reprojection, min-reprojection auto-masking with
identity tie-break noise, edge-aware disparity smoothness, the velocity
(translation-magnitude) term and the optional log-mean-disparity prior.
The expressions follow the JAX package's order, so their type promotion is
the same: a bf16 warped image keeps its SSIM pools in bf16 in both.  Where
pred equals target exactly, the L1 term's and the SSIM clip's subgradients
are jnp.abs's (+1 at 0) and jnp.clip's (0.5 at a bound), not torch's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

_SSIM_C1 = 0.01**2
_SSIM_C2 = 0.03**2


def _abs(u: torch.Tensor) -> torch.Tensor:
    """|u| whose gradient at u = 0 is +1, as jnp.abs's (torch.abs gives 0)."""
    return torch.where(u >= 0, u, -u)


def _clamp01(v: torch.Tensor) -> torch.Tensor:
    """clip(v, 0, 1) whose gradient at an exact bound is 0.5, as jnp.clip's
    (torch.clamp passes all of it)."""
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_ones(()))


def _reflect_pad_hw(x: torch.Tensor) -> torch.Tensor:
    """Reflection pad of one pixel on H and W of an NHWC tensor."""
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], dim=1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean pool, stride 1, valid, as two separable box filters."""
    x = (x[:, :-2] + x[:, 1:-1] + x[:, 2:]) / 3.0
    return (x[:, :, :-2] + x[:, :, 1:-1] + x[:, :, 2:]) / 3.0


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM distance clamp((1 - SSIM) / 2, 0, 1) of NHWC images, reflection
    padded so the output keeps the input's size -> (B, H, W, C)."""
    x = _reflect_pad_hw(x)
    y = _reflect_pad_hw(y)
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + _SSIM_C1) * (2 * sigma_xy + _SSIM_C2)
    d = (mu_x * mu_x + mu_y * mu_y + _SSIM_C1) * (sigma_x + sigma_y + _SSIM_C2)
    return _clamp01((1 - n / d) / 2)


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * L1, channel-averaged -> (B, H, W)."""
    l1 = _abs(target - pred).mean(-1)
    ssim_l = ssim(pred, target).mean(-1)
    return 0.85 * ssim_l + 0.15 * l1


def smooth_loss(disp: torch.Tensor, img: torch.Tensor,
                static_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edge-aware smoothness mean |d disp| * exp(-|d img|) -> (B,).

    disp (B, H, W, 1) mean-normalised disparity; img (B, H, W, 3); with
    `static_mask` (B, H, W), 1 = keep, the mean runs over static pixels
    only (the mask_dynamic pretraining path)."""
    d = disp[..., 0]
    grad_disp_x = (d[:, :, :-1] - d[:, :, 1:]).abs()
    grad_disp_y = (d[:, :-1, :] - d[:, 1:, :]).abs()
    grad_img_x = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1)
    grad_img_y = (img[:, :-1, :] - img[:, 1:, :]).abs().mean(-1)
    gx = grad_disp_x * torch.exp(-grad_img_x)
    gy = grad_disp_y * torch.exp(-grad_img_y)
    if static_mask is None:
        return gx.mean((1, 2)) + gy.mean((1, 2))
    mx = static_mask[:, :, :-1]
    my = static_mask[:, :-1, :]
    sx = (gx * mx).sum((1, 2)) / (mx.sum((1, 2)) + 1e-7)
    sy = (gy * my).sum((1, 2)) / (my.sum((1, 2)) + 1e-7)
    return sx + sy


def normalize_disp(disp: torch.Tensor) -> torch.Tensor:
    """disp / (mean_hw(disp) + 1e-7)."""
    return disp / (disp.mean((1, 2), keepdim=True) + 1e-7)


def velocity_loss(
    pred_translations: Dict[int, torch.Tensor],
    relative_distances: Dict[int, torch.Tensor],
) -> torch.Tensor:
    """Translation-magnitude supervision -> (B,).

    Frame 0 pairs translation(0,-1) with |relative_distance[0]|; frame 1
    pairs translation(0,1) with |relative_distance[1]|."""
    loss = torch.zeros_like(relative_distances[1])
    pairs = ((0, -1), (1, 1))
    for dist_frame, trans_frame in pairs:
        gt = relative_distances[dist_frame].abs()
        pred = torch.linalg.vector_norm(pred_translations[trans_frame], dim=-1)
        loss = loss + (pred - gt).abs()
    return loss / len(pairs)


def identity_reprojection(
    inputs: Dict, frame_ids: Tuple[int, ...] = (0, -1, 1)
) -> torch.Tensor:
    """Identity (unwarped) reprojection losses -> (B, F, H, W).  Model-free,
    so the adapt step computes it once per frame."""
    target = inputs[("rgb", 0, 0)]
    preds = [inputs[("rgb", f, 0)] for f in frame_ids[1:]]
    n, B = len(preds), target.shape[0]
    maps = reprojection_loss(torch.cat(preds), target.repeat(n, 1, 1, 1))
    return maps.reshape((n, B) + target.shape[1:3]).permute(1, 0, 2, 3)


def total_loss(
    inputs: Dict,
    outputs: Dict,
    *,
    scales: Sequence[int],
    frame_ids: Tuple[int, ...] = (0, -1, 1),
    disparity_smoothness: float = 1e-3,
    velocity_loss_scaling: Optional[float] = 0.05,
    sample_weights: Optional[torch.Tensor] = None,
    rng: Optional[torch.Generator] = None,
    dynamic_masks: Optional[Dict[int, torch.Tensor]] = None,
    identity_base: Optional[torch.Tensor] = None,
    scale_prior_weight: float = 0.0,
    scale_prior_disp: float = 0.15,
    reproj_maps: Optional[Dict[Tuple[int, int], torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Multi-scale loss with the reference `_compute_loss` semantics.

    inputs: ('rgb', f, 0) (B, H, W, 3) for f in frame_ids; ('rgb', 0, s)
    the target pyramid; ('relative_distance', f) (B,) for f in (0, 1).
    outputs: ('rgb', f, s) warped sources at full resolution; ('disp', s)
    sigmoid disparities; ('translation', 0, f) (B, 3) for f in (-1, 1).

    `sample_weights` default to 1/B.  `rng` draws the 1e-5 identity
    tie-break noise, fresh per scale and broadcast over the batch; None
    turns it off.  `reproj_maps` supplies precomputed (B, H, W) error maps
    per (frame, scale) in place of the reprojection_loss calls.

    `dynamic_masks` (scale -> (B, Hs, Ws), 1 = dynamic object) turns on the
    mask_dynamic pretraining path: the reprojection term averages over the
    static pixels of the whole batch (not per-sample weighted), and the
    smoothness term over each sample's static pixels.
    """
    target = inputs[("rgb", 0, 0)]
    B = target.shape[0]
    if sample_weights is None:
        sample_weights = torch.full((B,), 1.0 / B, dtype=target.dtype, device=target.device)

    losses: Dict[str, torch.Tensor] = {}
    total = target.new_zeros(())

    if identity_base is None:
        identity_base = identity_reprojection(inputs, frame_ids)
    noise = None
    if rng is not None:
        noise = 1e-5 * torch.randn(
            (len(scales), 1) + tuple(identity_base.shape[1:]), generator=rng,
            dtype=identity_base.dtype, device=identity_base.device,
        )

    for scale_i, scale in enumerate(scales):
        identity = identity_base if noise is None else identity_base + noise[scale_i]
        if reproj_maps is not None:
            reproj = torch.stack([reproj_maps[(f, scale)] for f in frame_ids[1:]], dim=1)
        else:
            reproj = torch.stack(
                [reprojection_loss(outputs[("rgb", f, scale)], target) for f in frame_ids[1:]],
                dim=1,
            )
        combined = torch.cat([identity, reproj], dim=1)
        to_optimize = combined.min(dim=1).values
        if dynamic_masks is not None:
            static0 = 1.0 - dynamic_masks[0]
            reproj_l = (to_optimize * static0).sum() / (static0.sum() + 1e-7)
        else:
            reproj_l = (to_optimize.mean((1, 2)) * sample_weights).sum()
        losses[f"reprojection_loss/scale_{scale}"] = reproj_l

        disp = outputs[("disp", scale)]
        color = inputs[("rgb", 0, scale)]
        if dynamic_masks is not None:
            smooth_l = smooth_loss(normalize_disp(disp), color,
                                   static_mask=1.0 - dynamic_masks[scale]).mean()
        else:
            smooth_l = (smooth_loss(normalize_disp(disp), color) * sample_weights).sum()
        losses[f"smooth_loss/scale_{scale}"] = smooth_l
        reg_l = disparity_smoothness / (2**scale) * smooth_l
        losses[f"reg_loss/scale_{scale}"] = reg_l

        scale_l = reproj_l + reg_l
        losses[f"depth_loss/scale_{scale}"] = scale_l
        total = total + scale_l

    total = total / len(scales)
    losses["depth_loss"] = total

    if scale_prior_weight > 0:
        mean_disp = outputs[("disp", scales[0])].mean((1, 2, 3))
        prior = (torch.log(mean_disp + 1e-7) - math.log(scale_prior_disp)) ** 2
        prior_l = scale_prior_weight * (prior * sample_weights).sum()
        losses["scale_prior_loss"] = prior_l
        total = total + prior_l

    if velocity_loss_scaling is not None and velocity_loss_scaling > 0:
        vel = velocity_loss(
            {f: outputs[("translation", 0, f)] for f in (-1, 1)},
            {f: inputs[("relative_distance", f)] for f in (0, 1)},
        )
        vel_l = velocity_loss_scaling * (vel * sample_weights).sum()
        losses["velocity_loss"] = vel_l
        total = total + vel_l

    losses["loss"] = total
    return losses
