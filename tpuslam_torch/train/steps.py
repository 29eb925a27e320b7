"""The per-frame adaptation and evaluation steps, and the pretraining step.

Counterpart of `tpuslam/train/steps.py`.  One SLAM frame (`adapt_step`):

1. the frozen depth and pose encoders run once, without autograd
   (`_frozen_features`): frozen weights, running BN statistics and fixed
   inputs make their outputs the same in every iteration;
2. K iterations of decoders -> `warp_and_loss` -> backward -> Adam over the
   decoders (`_adapt_scan`, a Python loop);
3. everything the host reads back is packed into one vector (`_pack_retire`).

On the card the iteration's forward and backward (2. less Adam) are one
CUDA graph (`IterationGraph`), replayed K times a frame once a state has
adapted twice with the same key (`_graph_key`), and Adam steps eagerly on
the gradients each replay leaves.  The tie-break noise is drawn eagerly
from `state.rng` before each iteration, so the generator's stream is the
same on either path.

The losses and outputs returned are the last iteration's, computed before
its optimizer step, as in the reference's adapt().  Networks run under bf16
autocast when the config's dtype is bfloat16; geometry, the warp and the
losses always run in float32, and TF32 is off inside every entry point
(`tpuslam_torch.full_fp32`).

One pretraining step (`train_step`) runs `forward` over the whole network,
encoders included, with batch norm in train mode, then backward and one
optimizer step over every parameter.

With the tracer on (`tpuslam_torch.tracing`) each step is a span
(`step.adapt`, `step.eval`, `step.consolidate`, `step.train`) holding its
phases: `step.frozen` or `step.encode`, each holding `step.encode.depth`
and `step.encode.pose` (the two encoders), then per iteration `step.iter`
with `step.decode`, `step.warp_loss`, `step.backward`, `step.adam`, and
`step.embed`, `step.pack`.  An iteration that replays the graph holds
`step.graph` (the replay) and `step.adam` instead: `step.decode`,
`step.warp_loss` and `step.backward` fire when an iteration runs eagerly or
is captured.  Counters: `graph.capture`, `graph.replay`.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from tpuslam_torch import at_least_f32, full_fp32, tracing
from tpuslam_torch.geometry.camera import (
    backproject_depth,
    bilinear_sampler,
    pixel_grid,
    project_3d,
    projection_affine,
    resize_bilinear,
)
from tpuslam_torch.geometry.depth import depth_to_disp, disp_to_depth
from tpuslam_torch.geometry.se3 import transformation_from_parameters
from tpuslam_torch.losses.photometric import identity_reprojection, tie_break_noise, total_loss
from tpuslam_torch.models.depth_pose import DepthPoseNet, l2_normalize
from tpuslam_torch.ops.reproj import reproj_err, warp_reproj_err, warp_reproj_err_proj
from tpuslam_torch.ops.warp import warp, warp_tall, warp_tall_proj, warp_two_kernel
from tpuslam_torch.train.batch import FrameBatch
from tpuslam_torch.train.state import TrainState, clone_train_state, train_state_tensors


class LossConfig(NamedTuple):
    """Loss hyperparameters and warp kernel choice of one run."""

    scales: Tuple[int, ...] = (0, 1, 2, 3)
    min_depth: Optional[float] = 0.1
    max_depth: Optional[float] = None
    disparity_smoothness: float = 1e-3
    velocity_loss_scaling: Optional[float] = 0.05
    # average the losses over the static pixels of `FrameBatch.mask` (the
    # dynamic-object masks of Cityscapes pretraining)
    mask_dynamic: bool = False
    # True: the warp runs the CUDA kernels of `ops/warp.py`; False: the plain
    # differentiable sampler `bilinear_sampler`
    use_pallas_warp: bool = True
    # store the warp's outputs (warped image and tap differentials) as bf16,
    # where the JAX package would run its kernel (`warp_and_loss`)
    pallas_bf16_out: bool = True
    # the static warp variants of the JAX package: `pallas_fused_grad` runs
    # K1 (stored taps); without it, or under an explicit `pallas_packed` or
    # `pallas_seg_skip`, the two-kernel warp K2 runs, its taps truncated to
    # bf16 for packed and seg-skip.  `pallas_extra_tiles` sets the JAX
    # package's height gate H >= 8 + 16 * extra_tiles of the static kernels.
    pallas_packed: bool = False
    pallas_seg_skip: bool = False
    pallas_fused_grad: bool = True
    pallas_extra_tiles: int = 2
    # the fused warp -> loss stack (JAX routing, `warp_and_loss`):
    # K4 deduplicated-source warp (`pallas_tall`), with K5's in-kernel
    # projection (`pallas_proj`, needs `pallas_tall`); K6 error maps with
    # their K6' backward (`pallas_fused_loss`); with all of tall, fused_loss
    # and fused_bwd, one K7/K8 backward in place of K6' and the warp's own
    pallas_tall: bool = False
    pallas_proj: bool = False
    pallas_fused_loss: bool = False
    pallas_fused_bwd: bool = False
    bf16_networks: bool = True  # `dtype: bfloat16`: networks under autocast
    scale_prior_weight: float = 0.0
    scale_prior_depth: float = 15.0


def loss_config(pc) -> LossConfig:
    """The LossConfig of a `DepthPoseConfig`, with every `pallas_*` flag mapped.

    `pallas_warp` selects the warp kernels and `pallas_bf16_out` their bf16
    storage; `pallas_fused_grad`, `pallas_packed` and `pallas_seg_skip`
    choose between K1 and the two-kernel warp K2 (exact or truncated taps);
    `pallas_tall`, `pallas_proj`, `pallas_fused_loss` and `pallas_fused_bwd`
    select the fused stack (K4-K8).  `warp_and_loss` routes them as the JAX
    package does.  The JAX package runs its warp kernels only at H % 8 == 0,
    W % 128 == 0 and W >= 384 (the static ones also at H >= 8 + 16 *
    `pallas_extra_tiles`) and runs its f32 sampler below that; the port's
    kernels have no shape limit and run at every shape, but store bf16 and
    truncate taps only where the JAX package's kernel would run, so both
    settings of `pallas_fused_grad` give the JAX package's result.
    `pallas_group_skip` shapes only the TPU kernels' sweep and is not
    mapped."""
    if pc.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {pc.dtype!r}")
    return LossConfig(
        scales=tuple(pc.scales),
        min_depth=pc.min_depth,
        max_depth=pc.max_depth,
        disparity_smoothness=pc.disparity_smoothness,
        velocity_loss_scaling=pc.velocity_loss_scaling,
        mask_dynamic=pc.mask_dynamic,
        use_pallas_warp=pc.pallas_warp,
        pallas_bf16_out=pc.pallas_bf16_out,
        pallas_packed=pc.pallas_packed,
        pallas_seg_skip=pc.pallas_seg_skip,
        pallas_fused_grad=pc.pallas_fused_grad,
        pallas_extra_tiles=pc.pallas_extra_tiles,
        pallas_tall=pc.pallas_tall,
        pallas_proj=pc.pallas_proj,
        pallas_fused_loss=pc.pallas_fused_loss,
        pallas_fused_bwd=pc.pallas_fused_bwd,
        bf16_networks=pc.dtype == "bfloat16",
    )


def _networks(bf16: bool, device: torch.device):
    """Autocast context for the networks (bf16 convs), a no-op for float32.
    Its cache of cast weights is off, as a CUDA graph's capture needs: each
    weight is used once in a block, so the cache saves no cast."""
    if not bf16:
        return nullcontext()
    return torch.autocast(device.type, dtype=torch.bfloat16, cache_enabled=False)


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
    noise: Optional[torch.Tensor] = None,
    identity_base: Optional[torch.Tensor] = None,
    pyramid: Optional[Dict[int, torch.Tensor]] = None,
):
    """Multi-scale inverse warp + loss from raw decoder outputs.

    `disps` maps ('disp', s) to the sigmoid disparity pyramid (NHWC);
    `aa`/`tr` are the doubled-batch (2B, 3) pose outputs ordered
    [pair (prev, cur); pair (cur, next)].  All (direction, scale) warps fold
    into one warp of the 2*S*B-image stack [direction, scale, batch].  The
    routing is the JAX package's (`tpuslam/train/steps.py:304-396`): with
    `pallas_tall` the warp reads the 2*B distinct sources (K4), and with
    `pallas_proj` too it projects in the kernel from depth and the affine
    maps of `projection_affine` (K5); otherwise the sources are tiled S-fold
    and K1 (`pallas_fused_grad`, no explicit variant) or the two-kernel K2
    warps the (2*S*B, H, W, 2) coordinates.  `pallas_fused_loss` computes all
    error maps in one kernel (K6) and hands them to `total_loss`; with
    `pallas_tall` and `pallas_fused_bwd` as well, the warp and the maps form
    one composite whose backward is one kernel (K7, or K8 with proj).

    The kernels have no shape limits, so every resolution takes them.  What
    they store follows the JAX package's gate, where its kernels run:
    `pallas_ok` (H % 8 == 0, W % 128 == 0, W >= 384) for the tall routes and
    `static_ok` (also H >= 8 + 16 * `pallas_extra_tiles`) for K1 and K2.
    Inside it K1, K4 and K5 store bf16 under `pallas_bf16_out`, and K2
    truncates its taps for packed or seg-skip; K2 always stores f32.  Below
    it every warp stores f32 with exact taps, like the JAX package's sampler.
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
    pallas_ok = H % 8 == 0 and W % 128 == 0 and W >= 384
    static_ok = pallas_ok and H >= 8 + 16 * cfg.pallas_extra_tiles
    use_tall = cfg.use_pallas_warp and cfg.pallas_tall
    tall_bf16 = cfg.pallas_bf16_out and pallas_ok
    use_proj = use_tall and cfg.pallas_proj
    target = batch.frame(0).contiguous()
    if use_proj:
        # the kernel projects: only the per-(direction, batch) affine maps
        # leave torch, never the points or the coordinate stack
        ab = projection_affine(_tile(batch.K, 2), _tile(batch.inv_K, 2),
                               torch.cat([T_prev, T_next]))
    else:
        T_stack = torch.cat([_tile(T_prev, S), _tile(T_next, S)])
        pix = pixel_grid(H, W, device=depth_stack.device, dtype=depth_stack.dtype)
        points = backproject_depth(depth_stack, _tile(batch.inv_K, S), pix)
        coords = project_3d(_tile(points, 2), _tile(batch.K, 2 * S), T_stack, H, W)
        coords = coords.contiguous()  # (2*S*B, H, W, 2)
    err_all = None
    if use_tall:
        src2 = torch.cat([batch.frame(-1), batch.frame(1)])  # deduplicated sources
        if cfg.pallas_fused_loss and cfg.pallas_fused_bwd:
            # one backward kernel; `warped` comes back detached, which is
            # exact because the loss reads the error maps
            if use_proj:
                err_all, warped = warp_reproj_err_proj(
                    src2, depth_stack, ab, target, S, tall_bf16)
            else:
                err_all, warped = warp_reproj_err(src2, coords, target, S, tall_bf16)
        elif use_proj:
            warped = warp_tall_proj(src2, depth_stack, ab, S, tall_bf16)
        else:
            warped = warp_tall(src2, coords, S, tall_bf16)
    else:
        src = torch.cat([_tile(batch.frame(-1), S), _tile(batch.frame(1), S)])
        # an explicitly requested packed or seg-skip variant takes the
        # two-kernel route
        explicit = cfg.pallas_packed or cfg.pallas_seg_skip
        if not cfg.use_pallas_warp:
            warped = bilinear_sampler(src, coords)
        elif cfg.pallas_fused_grad and not explicit:
            warped = warp(src, coords, cfg.pallas_bf16_out and static_ok)
        else:
            warped = warp_two_kernel(src, coords, static_ok and explicit)
    for fi, f in enumerate((-1, 1)):
        for si, s in enumerate(cfg.scales):
            start = (fi * S + si) * B
            outputs[("rgb", f, s)] = warped[start:start + B]

    # error maps of the whole warp stack in one kernel, read by total_loss
    # in place of its per-(frame, scale) reprojection_loss calls
    reproj_maps = None
    if cfg.pallas_fused_loss:
        if err_all is None:
            err_all = reproj_err(warped, target)
        reproj_maps = {}
        for fi, f in enumerate((-1, 1)):
            for si, s in enumerate(cfg.scales):
                start = (fi * S + si) * B
                reproj_maps[(f, s)] = err_all[start:start + B]

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
    dynamic_masks = None
    if cfg.mask_dynamic:
        # mask pyramid: 2x2 mean, then binary again; torch.round rounds the
        # 0.5 of a half-covered block to even (0), as jnp.round does
        mask = batch.mask if batch.mask is not None else target.new_zeros((B, H, W))
        dynamic_masks = {0: mask}
        for s in range(1, S):
            dynamic_masks[s] = torch.round(_avg_pool2(dynamic_masks[s - 1][..., None])[..., 0])
    losses = total_loss(
        inputs,
        outputs,
        scales=cfg.scales,
        disparity_smoothness=cfg.disparity_smoothness,
        velocity_loss_scaling=cfg.velocity_loss_scaling,
        sample_weights=batch.weights,
        rng=rng,
        noise=noise,
        dynamic_masks=dynamic_masks,
        identity_base=identity_base,
        reproj_maps=reproj_maps,
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
    with tracing.span("step.decode"), _networks(cfg.bf16_networks, pose_feat.device):
        disps = model.depth_decode(depth_feats)
        aa, tr = model.pose_decode(pose_feat)
    with tracing.span("step.warp_loss"):
        return warp_and_loss(disps, at_least_f32(aa), at_least_f32(tr), batch, cfg, **kwargs)


@contextmanager
def _bn_mode(model: DepthPoseNet, train: bool):
    """Batch norm in train mode (batch statistics, running statistics
    updated) or eval mode for the duration; the model's mode is restored."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def forward(model: DepthPoseNet, batch: FrameBatch, cfg: LossConfig, *,
            train_bn: bool = False, rng: Optional[torch.Generator] = None):
    """Full forward: encoders, decoders, warps and losses -> (losses,
    outputs), differentiable in every parameter.

    The depth encoder reads the augmented frame 0 and the pose encoder both
    pairs as one doubled batch of 2B (`_pose_pairs`), so that with
    `train_bn` its batch statistics are taken over the 2B pairs, as the JAX
    package takes them; the running statistics are updated in place.
    `outputs[('feat4',)]` is the pooled last depth feature."""
    with tracing.span("step.encode"), _bn_mode(model, train_bn), \
            _networks(cfg.bf16_networks, batch.rgb.device):
        depth_feats, pose_feats = _encode(model, batch)
    losses, outputs = _decode_and_loss(model, batch, cfg, depth_feats, pose_feats[-1], rng=rng)
    outputs[("feat4",)] = depth_feats[-1].mean((2, 3))
    return losses, outputs


def _frozen_features(model: DepthPoseNet, batch: FrameBatch, cfg: LossConfig):
    """Encoder features of the whole batch, outside autograd: frozen weights,
    running BN statistics and fixed inputs make them the same in every
    adaptation iteration, so they are computed once per frame."""
    with torch.no_grad(), _networks(cfg.bf16_networks, batch.rgb.device):
        depth_feats, pose_feats = _encode(model, batch)
    return depth_feats, pose_feats[-1]


def _encode(model: DepthPoseNet, batch: FrameBatch):
    """Both encoders' feature pyramids: the depth encoder's of the augmented
    frame 0, the pose encoder's of the 2B pairs."""
    with tracing.span("step.encode.depth"):
        depth_feats = model.depth_encode(batch.frame(0, aug=True))
    with tracing.span("step.encode.pose"):
        pose_feats = model.pose_encode(_pose_pairs(batch))
    return depth_feats, pose_feats


@tracing.traced("step.embed")
@full_fp32()
def embed(model: DepthPoseNet, image: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """L2-normalised pooled stage-4 depth-encoder feature of NHWC images."""
    with torch.no_grad(), _networks(cfg.bf16_networks, image.device):
        feat = model.depth_encode(image)[-1]
    return l2_normalize(feat.mean((2, 3)))


class IterInputs(NamedTuple):
    """What one adaptation iteration reads besides the decoders: the
    training batch and what the frame computes once, outside the loop."""

    batch: FrameBatch
    depth_feats: Tuple[torch.Tensor, ...]  # the frozen depth encoder's pyramid
    pose_feat: torch.Tensor  # the frozen pose encoder's last feature
    identity_base: torch.Tensor  # identity reprojection maps (B, 2, H, W)
    pyramid: Dict[int, torch.Tensor]  # target image pyramid by scale

    def tensors(self) -> List[torch.Tensor]:
        fields = [getattr(self.batch, f.name) for f in dataclasses.fields(self.batch)]
        return ([t for t in fields if t is not None] + list(self.depth_feats)
                + [self.pose_feat, self.identity_base]
                + [self.pyramid[s] for s in sorted(self.pyramid)])

    def clone(self) -> "IterInputs":
        batch = dataclasses.replace(self.batch, **{
            f.name: getattr(self.batch, f.name).clone() for f in dataclasses.fields(self.batch)
            if getattr(self.batch, f.name) is not None})
        return IterInputs(batch, tuple(t.clone() for t in self.depth_feats),
                          self.pose_feat.clone(), self.identity_base.clone(),
                          {s: t.clone() for s, t in self.pyramid.items()})


def frame_inputs(model: DepthPoseNet, cfg: LossConfig, training: FrameBatch) -> IterInputs:
    """What the frame computes once for its iterations: the frozen
    encoders' features, the identity reprojection maps and the target
    pyramid, outside autograd."""
    depth_feats, pose_feat = _frozen_features(model, training, cfg)
    with torch.no_grad():
        identity_base = identity_reprojection({
            ("rgb", 0, 0): training.frame(0),
            ("rgb", -1, 0): training.frame(-1),
            ("rgb", 1, 0): training.frame(1),
        })
        pyramid = _image_pyramid(training.frame(0), len(cfg.scales))
    return IterInputs(training, tuple(depth_feats), pose_feat, identity_base, pyramid)


def adapt_iteration(model: DepthPoseNet, cfg: LossConfig, inputs: IterInputs,
                    noise: Optional[torch.Tensor]):
    """One iteration's forward and backward: decoders -> warp and loss ->
    gradients into the decoders' `.grad`.  Returns (losses, outputs)."""
    losses, outputs = _decode_and_loss(
        model, inputs.batch, cfg, inputs.depth_feats, inputs.pose_feat, noise=noise,
        identity_base=inputs.identity_base, pyramid=inputs.pyramid)
    with tracing.span("step.backward"):
        losses["loss"].backward()
    return losses, outputs


def _graphable(device: torch.device) -> bool:
    """Whether adaptation on `device` may run as a CUDA graph."""
    return device.type == "cuda"


def _graph_key(state: TrainState, cfg: LossConfig, batch: FrameBatch) -> tuple:
    """What an iteration's graph depends on: the batch's shapes and dtypes,
    the loss configuration, the autocast state around the step, whether
    there is tie-break noise, and where the decoders' parameters live."""
    device = batch.rgb.device.type
    fields = [getattr(batch, f.name) for f in dataclasses.fields(batch)]
    decoders = (state.model.depth_decoder, state.model.pose_decoder)
    return (tuple(None if t is None else (tuple(t.shape), t.dtype) for t in fields), cfg,
            torch.is_autocast_enabled(device), torch.get_autocast_dtype(device),
            state.rng is not None,
            tuple(p.data_ptr() for m in decoders for p in m.parameters()))


class IterationGraph:
    """One adaptation iteration -- decoders, warp and loss, backward -- as a
    CUDA graph over static copies of its inputs (`IterInputs`, the noise).

    Built at the iteration it captures: the optimizer's gradients are set
    to None first, so the captured backward writes fresh gradients from the
    graph's pool and every replay overwrites them in place; the optimizer
    then steps eagerly on them.  `losses` and `outputs` are the graph's own
    tensors, which the next replay overwrites.  The launches recorded while
    capturing (`launches.<entry>`) are counted at every replay instead.

    A capture needs the autograd graphs of the state's earlier, eager
    iterations freed: a tensor of one that is still held keeps the
    parameters' gradient accumulators on the stream they were made on,
    which the capture's stream cannot wait for."""

    def __init__(self, key: tuple, state: TrainState, cfg: LossConfig, inputs: IterInputs,
                 noise: Optional[torch.Tensor]):
        self.key = key
        self.inputs = inputs.clone()
        self.noise = None if noise is None else noise.clone()
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        with tracing.tally("launches.") as self.launches:
            losses, outputs = self._record(
                lambda: adapt_iteration(state.model, cfg, self.inputs, self.noise))
        self.losses = {k: v.detach() for k, v in losses.items()}
        self.outputs = {k: v.detach() for k, v in outputs.items()}
        self.grads = [(p, p.grad) for group in opt.param_groups for p in group["params"]]
        tracing.count("graph.capture")

    def _record(self, fn):
        """Capture `fn` (nothing runs on the device); returns its outputs."""
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            return fn()

    def _replay(self) -> None:
        self.graph.replay()

    def holds_gradients(self) -> bool:
        """Whether the optimizer's parameters still hold the graph's
        gradients (nobody has set them to None since the capture)."""
        return all(p.grad is g for p, g in self.grads)

    def load(self, inputs: IterInputs) -> None:
        """Copy a frame's inputs into the static ones."""
        torch._foreach_copy_(self.inputs.tensors(), inputs.tensors())

    def run(self, noise: Optional[torch.Tensor]):
        """Replay with `noise`; returns the graph's (losses, outputs)."""
        if noise is not None:
            self.noise.copy_(noise)
        with tracing.span("step.graph"):
            self._replay()
        if tracing.on:
            tracing.count("graph.replay")
            for k, n in self.launches.items():
                tracing.count(k, n)
        return self.losses, self.outputs


def _frame_graph(state: TrainState, cfg: LossConfig, batch: FrameBatch):
    """(graph to replay, key to capture under): (None, None) runs the frame
    eagerly.  A graph is used on the card only, from a state's second
    adaptation with the same key as its last; a changed key drops the
    graph, and the next adaptation with that key captures anew."""
    if not _graphable(batch.rgb.device):
        return None, None
    key = _graph_key(state, cfg, batch)
    last, state.graph_key = state.graph_key, key
    graph = state.graph
    if graph is not None and graph.key == key and graph.holds_gradients():
        return graph, None
    state.graph = None
    return None, key if key == last else None


def _adapt_scan(state: TrainState, cfg: LossConfig, training: FrameBatch, num_steps: int,
                with_outputs: bool = True):
    """K iterations of decode -> warp and loss -> backward -> Adam.

    Returns (last losses, last outputs without the warped images, per-
    iteration losses (K,), pooled stage-4 feature of the frozen encoder);
    with `with_outputs=False` the losses and outputs are empty dicts.  What
    it returns is fresh, never a graph's own tensor."""
    if num_steps < 1:
        raise ValueError(f"adaptation requires num_steps >= 1, got {num_steps}")
    model, opt = state.model, state.optimizer
    with tracing.span("step.frozen"):
        inputs = frame_inputs(model, cfg, training)
        feat4 = inputs.depth_feats[-1].mean((2, 3))
    graph, capture_key = _frame_graph(state, cfg, training)
    if graph is not None:
        graph.load(inputs)

    iter_losses = []
    for _ in range(num_steps):
        with tracing.span("step.iter"):
            noise = None
            if state.rng is not None:
                noise = tie_break_noise(state.rng, inputs.identity_base, len(cfg.scales))
            if capture_key is not None:
                graph = state.graph = IterationGraph(capture_key, state, cfg, inputs, noise)
                capture_key = None
            if graph is not None:
                losses, outputs = graph.run(noise)
                iter_losses.append(losses["loss"].clone())
            else:
                opt.zero_grad(set_to_none=True)
                losses, outputs = adapt_iteration(model, cfg, inputs, noise)
                iter_losses.append(losses["loss"].detach())
            with tracing.span("step.adam"):
                opt.step()
    if not with_outputs:
        return {}, {}, torch.stack(iter_losses), feat4
    # a graph's tensors are detached already, and the next replay writes them
    keep = torch.Tensor.clone if graph is not None else torch.Tensor.detach
    losses = {k: keep(v) for k, v in losses.items()}
    outputs = {k: keep(v) for k, v in outputs.items() if k[0] != "rgb"}
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


@tracing.traced("step.adapt")
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
    with tracing.span("step.pack"):
        outputs[("retire_packed",)] = _pack_retire(losses, outputs)
    losses["iter_losses"] = iter_losses
    state.step += 1
    return losses, outputs


@tracing.traced("step.consolidate")
@full_fp32()
def consolidate_step(state: TrainState, cfg: LossConfig, batch: FrameBatch, num_steps: int,
                     freeze_encoder: bool = True) -> torch.Tensor:
    """Update-only step, in place: K adaptation iterations over the
    decoders with no outputs for the host (the generalist's replay
    consolidation in dual-network mode, and the CoVIO update).  Returns the
    per-iteration losses (K,)."""
    if not freeze_encoder:
        raise NotImplementedError(
            "consolidate_step(freeze_encoder=False): the port's consolidation keeps the "
            "encoders frozen (clone_train_state shares them between clones); the training "
            "path that trains them is `train_step`")
    _, _, iter_losses, _ = _adapt_scan(state, cfg, batch, num_steps, with_outputs=False)
    state.step += 1
    return iter_losses


def consolidate_step_async(state: TrainState, cfg: LossConfig, batch: FrameBatch,
                           num_steps: int, stream: Optional[torch.cuda.Stream] = None,
                           freeze_encoder: bool = True):
    """`consolidate_step` on a clone of `state`, which stays untouched and
    can go on serving while the update runs (the CoVIO update).

    On the card the clone is made and updated on `stream`, after that
    stream has waited for the work queued so far on the current one (the
    batch's copies).  The batch's tensors and the source state's are
    recorded on `stream`, so that the allocator does not hand their memory
    to another stream while the update reads it.  Returns (clone, event recorded on `stream` after the
    update's last operation); the caller makes its stream wait on the event
    before it reads the clone.  Without a stream (the CPU) the update runs
    synchronously and the event is None.  The clone adapts once, so it
    runs eagerly, never as a CUDA graph."""
    if stream is None:
        clone = clone_train_state(state)
        consolidate_step(clone, cfg, batch, num_steps, freeze_encoder)
        return clone, None
    stream.wait_stream(torch.cuda.current_stream())
    read = [getattr(batch, field.name) for field in dataclasses.fields(batch)]
    for t in read + train_state_tensors(state):
        if t is not None and t.is_cuda:
            t.record_stream(stream)
    with torch.cuda.stream(stream):
        clone = clone_train_state(state)
        consolidate_step(clone, cfg, batch, num_steps, freeze_encoder)
        event = torch.cuda.Event()
        event.record(stream)
    return clone, event


@tracing.traced("step.eval")
@torch.no_grad()
@full_fp32()
def eval_step(model: DepthPoseNet, cfg: LossConfig, batch: FrameBatch,
              with_lc_embedding: bool = False):
    """No-grad forward: losses + outputs + normalised embedding (the
    `adaptation: false` SLAM path).  The warp runs without taps (K1, K2, K4
    or K5, as the flags route it) and no backward kernel runs.  With
    `with_lc_embedding`, the loop-closure embedding of the +1 frames (the
    encoder only) is packed too."""
    with tracing.span("step.frozen"):
        depth_feats, pose_feat = _frozen_features(model, batch, cfg)
    losses, outputs = _decode_and_loss(model, batch, cfg, depth_feats, pose_feat)
    outputs[("feat4",)] = depth_feats[-1].mean((2, 3))
    outputs[("embedding",)] = l2_normalize(outputs[("feat4",)])
    if with_lc_embedding:
        outputs[("lc_embedding",)] = embed(model, batch.frame(1), cfg)
    with tracing.span("step.pack"):
        outputs[("retire_packed",)] = _pack_retire(losses, outputs)
    return losses, outputs


@tracing.traced("step.train")
@full_fp32()
def train_step(state: TrainState, cfg: LossConfig, batch: FrameBatch) -> Dict[str, torch.Tensor]:
    """One pretraining step, in place: `forward` with batch norm in train
    mode, backward through the whole network, one step of the state's
    optimizer over all parameters.  The tie-break noise comes from
    `state.rng` (None turns it off).  Returns the step's losses, detached
    and on the device (no host sync)."""
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    losses, _ = forward(state.model, batch, cfg, train_bn=True, rng=state.rng)
    with tracing.span("step.backward"):
        losses["loss"].backward()
    with tracing.span("step.adam"):
        opt.step()
    state.step += 1
    return {k: v.detach() for k, v in losses.items()}


@torch.no_grad()
@full_fp32()
def predict_pose_step(model: DepthPoseNet, image_0: torch.Tensor, image_1: torch.Tensor,
                      bf16_networks: bool = False):
    """Relative pose between two NHWC image batches (reference
    `predict_pose`): channel-concatenated pair -> pose network -> forward
    transform (B, 4, 4), with the identity (6, 6) as placeholder covariance."""
    pair = torch.cat([image_0, image_1], dim=-1)
    with _networks(bf16_networks, pair.device):
        aa, tr = model.pose_forward(pair)
    T = transformation_from_parameters(aa.float(), tr.float(), invert=False)
    return T, torch.eye(6, device=pair.device)


@torch.no_grad()
@full_fp32()
def predict_depth_step(model: DepthPoseNet, image: torch.Tensor, min_depth=0.1,
                       max_depth=None, bf16_networks: bool = False):
    """Depth (B, H, W, 1) of NHWC images (reference `predict_from_image`) and
    the normalised pooled stage-4 depth-encoder feature (B, D), D the
    encoder's last width."""
    with _networks(bf16_networks, image.device):
        disps, feat4 = model.depth_forward(image)
    return disp_to_depth(disps[("disp", 0)], min_depth, max_depth), l2_normalize(feat4)
