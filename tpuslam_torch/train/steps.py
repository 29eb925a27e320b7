"""The per-frame adaptation and evaluation steps.

Counterpart of `tpuslam/train/steps.py`.  One SLAM frame (`adapt_step`):

1. the frozen depth and pose encoders run once, without autograd
   (`_frozen_features`): frozen weights, running BN statistics and fixed
   inputs make their outputs the same in every iteration;
2. K iterations of decoders -> `warp_and_loss` -> backward -> Adam over the
   decoders (`_adapt_scan`, a Python loop);
3. everything the host reads back is packed into one vector (`_pack_retire`).

The losses and outputs returned are the last iteration's, computed before
its optimizer step, as in the reference's adapt().  Networks run under bf16
autocast when the config's dtype is bfloat16; geometry, the warp and the
losses always run in float32, and TF32 is off inside every entry point
(`tpuslam_torch.full_fp32`).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from tpuslam_torch import full_fp32
from tpuslam_torch.geometry.camera import (
    backproject_depth,
    bilinear_sampler,
    pixel_grid,
    project_3d,
    resize_bilinear,
)
from tpuslam_torch.geometry.depth import depth_to_disp, disp_to_depth
from tpuslam_torch.geometry.se3 import transformation_from_parameters
from tpuslam_torch.losses.photometric import identity_reprojection, total_loss
from tpuslam_torch.models.depth_pose import DepthPoseNet, l2_normalize
from tpuslam_torch.ops.warp import warp
from tpuslam_torch.train.batch import FrameBatch
from tpuslam_torch.train.state import TrainState

# DepthPoseConfig flags whose TPU kernels have no port yet, with the
# ROADMAP.md Queue 2 entry that ports them
_UNPORTED_FLAGS = {
    "pallas_packed": "K2 (packed taps)",
    "pallas_seg_skip": "K2 (seg-skip sweep)",
    "pallas_tall": "K4 (deduplicated-source warp)",
    "pallas_proj": "K5 (in-kernel projection warp)",
    "pallas_fused_loss": "K6 (SSIM + L1 error map)",
    "pallas_fused_bwd": "K7/K8 (fused error-and-warp backward)",
}


class LossConfig(NamedTuple):
    """Loss hyperparameters and warp kernel choice of one run."""

    scales: Tuple[int, ...] = (0, 1, 2, 3)
    min_depth: Optional[float] = 0.1
    max_depth: Optional[float] = None
    disparity_smoothness: float = 1e-3
    velocity_loss_scaling: Optional[float] = 0.05
    # True: the warp runs kernel K1 (CUDA, `ops/warp.py`); False: the plain
    # differentiable sampler `bilinear_sampler`
    use_pallas_warp: bool = True
    # store K1's outputs (warped image and tap differentials) as bf16
    pallas_bf16_out: bool = True
    bf16_networks: bool = True  # `dtype: bfloat16`: networks under autocast
    scale_prior_weight: float = 0.0
    scale_prior_depth: float = 15.0


def loss_config(pc) -> LossConfig:
    """The LossConfig of a `DepthPoseConfig`, with every `pallas_*` flag mapped.

    `pallas_warp` selects K1 and `pallas_bf16_out` its bf16 storage.
    `pallas_group_skip` and `pallas_extra_tiles` shape only the TPU kernel's
    source window, so they have no effect on the port's exact kernel; nor has
    `pallas_fused_grad`, whose two settings give the same gradient (K1 stores
    the tap differentials either way).  The flags of kernels not ported yet
    raise NotImplementedError."""
    for flag, entry in _UNPORTED_FLAGS.items():
        if getattr(pc, flag):
            raise NotImplementedError(
                f"{flag}=True needs kernel {entry}, not ported yet (ROADMAP.md Queue 2)"
            )
    if pc.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {pc.dtype!r}")
    return LossConfig(
        scales=tuple(pc.scales),
        min_depth=pc.min_depth,
        max_depth=pc.max_depth,
        disparity_smoothness=pc.disparity_smoothness,
        velocity_loss_scaling=pc.velocity_loss_scaling,
        use_pallas_warp=pc.pallas_warp,
        pallas_bf16_out=pc.pallas_bf16_out,
        bf16_networks=pc.dtype == "bfloat16",
    )


def _networks(cfg: LossConfig, device: torch.device):
    """Autocast context for the networks (bf16 convs), a no-op for float32."""
    if not cfg.bf16_networks:
        return nullcontext()
    return torch.autocast(device.type, dtype=torch.bfloat16)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean-pool downsample (NHWC) for the target pyramid."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean((2, 4))


def _image_pyramid(img: torch.Tensor, num_scales: int) -> Dict[int, torch.Tensor]:
    pyr = {0: img}
    for s in range(1, num_scales):
        pyr[s] = _avg_pool2(pyr[s - 1])
    return pyr


def _pose_pairs(batch: FrameBatch) -> torch.Tensor:
    """Both pose pairs (-1, 0) and (0, +1) as one doubled batch (2B, H, W, 6)."""
    pair_prev = torch.cat([batch.frame(-1, True), batch.frame(0, True)], dim=-1)
    pair_next = torch.cat([batch.frame(0, True), batch.frame(1, True)], dim=-1)
    return torch.cat([pair_prev, pair_next])


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.repeat((n,) + (1,) * (x.dim() - 1))


def warp_and_loss(
    disps: Dict[Any, torch.Tensor],
    aa: torch.Tensor,
    tr: torch.Tensor,
    batch: FrameBatch,
    cfg: LossConfig,
    *,
    rng: Optional[torch.Generator] = None,
    identity_base: Optional[torch.Tensor] = None,
    pyramid: Optional[Dict[int, torch.Tensor]] = None,
):
    """Multi-scale inverse warp + loss from raw decoder outputs.

    `disps` maps ('disp', s) to the sigmoid disparity pyramid (NHWC);
    `aa`/`tr` are the doubled-batch (2B, 3) pose outputs ordered
    [pair (prev, cur); pair (cur, next)].  All (direction, scale) warps fold
    into one projection and one warp of 2*S*B images: the sources are tiled
    S-fold and the coordinates are (2*S*B, H, W, 2).  K1 has no shape limits,
    so every resolution takes it when `use_pallas_warp` is set.
    """
    H, W = batch.height, batch.width
    B = batch.batch_size
    S = len(cfg.scales)
    T_prev = transformation_from_parameters(aa[:B], tr[:B], invert=True)
    T_next = transformation_from_parameters(aa[B:], tr[B:], invert=False)

    outputs: Dict[Any, torch.Tensor] = {}
    depths = []
    for s in cfg.scales:
        disp = disps[("disp", s)]
        depth = disp_to_depth(resize_bilinear(disp, H, W), cfg.min_depth, cfg.max_depth)
        if s == 0:
            outputs[("depth", 0)] = depth
        depths.append(depth)
        outputs[("disp", s)] = disp

    depth_stack = torch.cat(depths)  # (S*B, H, W, 1)
    T_stack = torch.cat([_tile(T_prev, S), _tile(T_next, S)])
    pix = pixel_grid(H, W, device=depth_stack.device)
    points = backproject_depth(depth_stack, _tile(batch.inv_K, S), pix)
    coords = project_3d(_tile(points, 2), _tile(batch.K, 2 * S), T_stack, H, W)
    src = torch.cat([_tile(batch.frame(-1), S), _tile(batch.frame(1), S)])
    if cfg.use_pallas_warp:
        warped = warp(src, coords.contiguous(), cfg.pallas_bf16_out)
    else:
        warped = bilinear_sampler(src, coords)
    for fi, f in enumerate((-1, 1)):
        for si, s in enumerate(cfg.scales):
            start = (fi * S + si) * B
            outputs[("rgb", f, s)] = warped[start:start + B]

    outputs[("cam_T_cam", 0, -1)] = T_prev
    outputs[("cam_T_cam", 0, 1)] = T_next
    outputs[("translation", 0, -1)] = tr[:B]
    outputs[("translation", 0, 1)] = tr[B:]

    pyr = pyramid if pyramid is not None else _image_pyramid(batch.frame(0), S)
    inputs = {("rgb", 0, s): pyr[s] for s in cfg.scales}
    inputs[("rgb", -1, 0)] = batch.frame(-1)
    inputs[("rgb", 1, 0)] = batch.frame(1)
    inputs[("relative_distance", 0)] = batch.rel_dist[:, 0]
    inputs[("relative_distance", 1)] = batch.rel_dist[:, 1]
    losses = total_loss(
        inputs,
        outputs,
        scales=cfg.scales,
        disparity_smoothness=cfg.disparity_smoothness,
        velocity_loss_scaling=cfg.velocity_loss_scaling,
        sample_weights=batch.weights,
        rng=rng,
        identity_base=identity_base,
        scale_prior_weight=cfg.scale_prior_weight,
        scale_prior_disp=(
            depth_to_disp(cfg.scale_prior_depth, cfg.min_depth, cfg.max_depth)
            if cfg.scale_prior_weight > 0 else 0.0
        ),
    )
    return losses, outputs


def _decode_and_loss(model: DepthPoseNet, batch: FrameBatch, cfg: LossConfig,
                     depth_feats, pose_feat, **kwargs):
    """Decoder halves + warps + losses, given encoder features."""
    with _networks(cfg, pose_feat.device):
        disps = model.depth_decode(depth_feats)
        aa, tr = model.pose_decode(pose_feat)
    return warp_and_loss(disps, aa.float(), tr.float(), batch, cfg, **kwargs)


def _frozen_features(model: DepthPoseNet, batch: FrameBatch, cfg: LossConfig):
    """Encoder features of the whole batch, outside autograd: frozen weights,
    running BN statistics and fixed inputs make them the same in every
    adaptation iteration, so they are computed once per frame."""
    with torch.no_grad(), _networks(cfg, batch.rgb.device):
        depth_feats = model.depth_encode(batch.frame(0, aug=True))
        pose_feats = model.pose_encode(_pose_pairs(batch))
    return depth_feats, pose_feats[-1]


@full_fp32()
def embed(model: DepthPoseNet, image: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """L2-normalised pooled stage-4 depth-encoder feature of NHWC images."""
    with torch.no_grad(), _networks(cfg, image.device):
        feat = model.depth_encode(image)[-1]
    return l2_normalize(feat.mean((2, 3)))


def _adapt_scan(state: TrainState, cfg: LossConfig, training: FrameBatch, num_steps: int):
    """K iterations of decode -> warp and loss -> backward -> Adam.

    Returns (last losses, last outputs without the warped images, per-
    iteration losses (K,), pooled stage-4 feature of the frozen encoder)."""
    if num_steps < 1:
        raise ValueError(f"adaptation requires num_steps >= 1, got {num_steps}")
    model, opt = state.model, state.optimizer
    depth_feats, pose_feat = _frozen_features(model, training, cfg)
    feat4 = depth_feats[-1].mean((2, 3))
    with torch.no_grad():
        identity_base = identity_reprojection({
            ("rgb", 0, 0): training.frame(0),
            ("rgb", -1, 0): training.frame(-1),
            ("rgb", 1, 0): training.frame(1),
        })
        pyramid = _image_pyramid(training.frame(0), len(cfg.scales))

    iter_losses = []
    for _ in range(num_steps):
        losses, outputs = _decode_and_loss(
            model, training, cfg, depth_feats, pose_feat, rng=state.rng,
            identity_base=identity_base, pyramid=pyramid,
        )
        opt.zero_grad(set_to_none=True)
        losses["loss"].backward()
        opt.step()
        iter_losses.append(losses["loss"].detach())
    losses = {k: v.detach() for k, v in losses.items()}
    outputs = {k: v.detach() for k, v in outputs.items() if k[0] != "rgb"}
    return losses, outputs, torch.stack(iter_losses), feat4


def _pack_retire(losses, outputs) -> torch.Tensor:
    """Everything `Slam._retire` reads per frame, as one f32 vector:
    [T01 (16) | embedding (D) | depth / velocity / total loss (3) |
    lc_embedding (D_lc, when present)] -- one device-to-host copy."""
    zero = outputs[("embedding",)].new_zeros(())
    parts = [
        outputs[("cam_T_cam", 0, 1)][0].reshape(-1).float(),
        outputs[("embedding",)][0].float(),
        torch.stack([losses.get(k, zero).float()
                     for k in ("depth_loss", "velocity_loss", "loss")]),
    ]
    if ("lc_embedding",) in outputs:
        parts.append(outputs[("lc_embedding",)][0].float())
    return torch.cat(parts)


@full_fp32()
def adapt_step(
    state: TrainState,
    cfg: LossConfig,
    training: FrameBatch,
    num_steps: int,
    with_lc_embedding: bool = True,
):
    """One SLAM frame: K adaptation iterations over the decoders, in place.

    Runs on the device of `state` and `training`.  Returns (losses, outputs)
    of the last iteration's forward; the online frame is training row 0, so
    `outputs[('cam_T_cam', 0, 1)][0]` is the odometry transform.  The
    replay and loop-closure embeddings come from the frozen encoders.
    """
    losses, outputs, iter_losses, feat4 = _adapt_scan(state, cfg, training, num_steps)
    outputs[("feat4",)] = feat4
    outputs[("embedding",)] = l2_normalize(feat4)
    if with_lc_embedding:
        outputs[("lc_embedding",)] = embed(state.model, training.frame(1)[:1], cfg)
    outputs[("retire_packed",)] = _pack_retire(losses, outputs)
    losses["iter_losses"] = iter_losses
    state.step += 1
    return losses, outputs


@torch.no_grad()
@full_fp32()
def eval_step(model: DepthPoseNet, cfg: LossConfig, batch: FrameBatch):
    """No-grad forward: losses + outputs + normalised embedding (the
    `adaptation: false` SLAM path).  The warp runs K1 without taps."""
    depth_feats, pose_feat = _frozen_features(model, batch, cfg)
    losses, outputs = _decode_and_loss(model, batch, cfg, depth_feats, pose_feat)
    outputs[("feat4",)] = depth_feats[-1].mean((2, 3))
    outputs[("embedding",)] = l2_normalize(outputs[("feat4",)])
    outputs[("retire_packed",)] = _pack_retire(losses, outputs)
    return losses, outputs
