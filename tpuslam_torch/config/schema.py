"""Typed configuration schema — the same five sections as the reference.

Field names follow the reference dataclasses (datasets/config.py:7-14,
depth_pose_prediction/config.py:7-32, loop_closure_detection/config.py:6-10,
slam/config.py:6-25) so existing YAML configs translate mechanically; TPU-
specific knobs (dtype, embedder choice, buffer storage mode) are additive.
The shipped reference `config_pretrain.yaml` uses stale keys (`type`,
`resnet`) that its own parser would reject (SURVEY §5); our defaults are
modernised rather than reproducing that breakage.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple, Union


@dataclasses.dataclass
class DatasetConfig:
    dataset: str = "Synthetic"  # Kitti | RobotCar | Cityscapes | Synthetic
    dataset_path: Optional[Path] = None
    height: int = 192
    width: int = 640
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    frame_ids: Tuple[int, ...] = (0, -1, 1)
    # synthetic-only knobs
    num_frames: int = 128
    trajectory: str = "curve"
    speed: float = 1.0  # meters / frame along the trajectory
    # LiDAR-like sparse GT depth (KITTI-geometry dress rehearsal): the
    # synthetic gt-depth maps carry a fixed 64-beam projection validity
    # pattern (~5-8% density, rows below the horizon only, 0 = invalid)
    # so the metric path sees real-KITTI gt sparsity end-to-end.
    sparse_depth: bool = False
    config_file: Optional[Path] = None


@dataclasses.dataclass
class DepthPoseConfig:
    train_set: Optional[Union[Tuple, int, str]] = "all"
    val_set: Optional[Union[Tuple, int, str]] = 0
    resnet_depth: int = 18
    resnet_pose: int = 18
    # ImageNet-initialised encoders like the reference's pretrained=True
    # (resnet_encoder.py:47-76): set encoder_weights to a local torchvision
    # ResNet .pth (no download in zero-egress envs) — conv1 is replicated/
    # averaged for the 2-image pose stem.  resnet_pretrained=True makes a
    # missing/invalid encoder_weights a hard error instead of a warning.
    resnet_pretrained: bool = False
    encoder_weights: Optional[Path] = None
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    learning_rate: float = 1e-4
    scheduler_step_size: int = 15
    batch_size: int = 3
    num_workers: int = 0
    num_epochs: int = 25
    min_depth: Optional[float] = 0.1
    max_depth: Optional[float] = None
    disparity_smoothness: float = 1e-3
    velocity_loss_scaling: Optional[float] = 0.05
    mask_dynamic: bool = False
    # anti-collapse disparity prior for the first N pretraining epochs
    # (0 = off; see losses/photometric.py scale_prior_weight)
    scale_prior_epochs: int = 0
    scale_prior_weight: float = 0.01
    log_path: Path = Path("./log/run")
    save_frequency: int = -1
    save_val_depth: bool = False
    # batches of panels per epoch when save_val_depth is on (values < 1
    # are treated as 1 so enabling the boolean alone saves something)
    save_val_depth_batches: int = 1
    load_weights_folder: Optional[Path] = None
    use_wandb: bool = False
    # TPU-native knobs
    # Conv compute dtype; params and geometry stay f32.  bfloat16 is the
    # default: rides the MXU's native precision, and the rung-2 quality A/B
    # measured equal ATE/abs_rel at +28% end-to-end fps (BASELINE.md round
    # 3).  Set "float32" to reproduce reference numerics exactly.
    dtype: str = "bfloat16"
    dp_devices: int = 1  # data-parallel mesh size for pretraining
    # Pallas static-window warp kernel (~6x faster warp stage on TPU; exact
    # within one (8,128) tile of displacement, clamped beyond — see
    # tpuslam/ops/pallas_warp.py).  Falls back to the XLA sampler off-TPU
    # or at incompatible resolutions.
    pallas_warp: bool = True
    # Warp-kernel gather variants (ops/pallas_warp.py; opt-in pending
    # on-silicon A/B): `pallas_packed` rides both horizontal taps in one
    # u32 lane (bf16 tap precision, half the gathers); `pallas_seg_skip`
    # additionally predicates the sweep per 128-lane window segment
    # (~1/6 the gathers of the dense f32 sweep, implies packed taps).
    pallas_packed: bool = False
    pallas_seg_skip: bool = False
    # `pallas_group_skip` predicates the dense f32 sweep per vertical
    # TILE_H-row window group (tap-identical, no added per-row arithmetic —
    # the packed variants' measured failure mode; BASELINE.md 2026-08-18).
    # Default ON (measured faster at every window height).
    pallas_group_skip: bool = True
    # Static-warp window height = 8 + 2*extra_tiles*8 rows.  Default 2:
    # ~16-24 px exact vertical-flow margin (near-field road rows exceed
    # the extra_tiles=1 ~8 px margin — ADVICE r2), ~6% slower than 1 under
    # the group-predicated sweep.
    pallas_extra_tiles: int = 2
    # `pallas_fused_grad` stores the warp's tap differentials at forward
    # time so the VJP needs no backward gather sweep (gradient-identical;
    # see train/steps.py LossConfig).  Ignored when an explicit
    # packed/seg_skip/sparse variant is requested.
    pallas_fused_grad: bool = True
    # `pallas_fused_loss` computes the per-pixel reprojection error
    # (SSIM + L1) in one VMEM-resident Pallas pass per warped prediction
    # instead of XLA reduce-window chains (ops/pallas_loss.py; maps match
    # to ~5e-6, gradient via in-kernel jax.vjp).  Opt-in pending
    # on-silicon measurement.
    pallas_fused_loss: bool = False
    # `pallas_bf16_out` stores the fused warp kernel's outputs in bfloat16
    # (math stays f32; halves their HBM traffic, <= ~4e-3 rounding on
    # image data).  DEFAULT ON since round 5: faster in two relay sessions
    # and better-or-equal on every seed/metric of the 3-seed 192x640
    # quality A/B (BASELINE.md); False restores exact f32 storage.
    pallas_bf16_out: bool = True
    # `pallas_tall` uses the full-height column-stripe warp kernel: src
    # windows DMA once per (image, stripe) (~20x less HBM src traffic),
    # sources deduped across scales, unlimited vertical exactness.
    # Opt-in pending on-silicon measurement.
    pallas_tall: bool = False
    # `pallas_fused_bwd` (with pallas_tall + pallas_fused_loss): one fused
    # backward kernel contracts d(err)/d(pred) with the warp tap
    # differentials in VMEM — the dpred stack never round-trips HBM.
    # Gradient-identical; opt-in pending on-silicon measurement.
    pallas_fused_bwd: bool = False
    # `pallas_proj` (with pallas_tall): compute warp coordinates IN-KERNEL
    # from depth + per-(direction, batch) affine camera maps — the XLA
    # backproject/project stage and its points/coords HBM round trips
    # disappear (train/steps.py LossConfig).  Opt-in pending measurement.
    pallas_proj: bool = False
    # Per-head online LR split (train/state.py make_adapt_optimizer): the
    # depth decoder adapts at learning_rate * adapt_depth_lr_scale, the pose
    # decoder at the full rate.  1.0 = reference-exact (both heads share one
    # LR); 0.0 freezes the depth decoder online.  Mitigates the online
    # depth/odometry trade-off (ATE -73% but abs_rel 0.187 -> 0.42 at 1.0,
    # BASELINE.md round-2 trained ladder).
    adapt_depth_lr_scale: float = 1.0
    config_file: Optional[Path] = None


@dataclasses.dataclass
class ReplayBufferConfig:
    maximize_diversity: bool = True
    max_buffer_size: int = 100
    similarity_threshold: float = 0.95
    similarity_sampling: bool = False
    load_path: Optional[Path] = None
    config_file: Optional[Path] = None


@dataclasses.dataclass
class LoopClosureConfig:
    detection_threshold: float = 0.99
    id_threshold: int = 250
    num_matches: int = 1
    # 'mobilenet' (576-d, reference parity) or 'depth_encoder' (the pooled
    # stage-4 feature, 512-d at ResNet-18/34 and 2048-d at 50, zero extra
    # FLOPs — the TPU-native default)
    embedder: str = "depth_encoder"
    # torchvision mobilenet_v3_small .pth to load for the 'mobilenet'
    # embedder (reference uses ImageNet weights; random init degrades
    # retrieval and the 0.99 threshold is calibrated to pretrained features)
    embedder_weights: Optional[Path] = None
    config_file: Optional[Path] = None


@dataclasses.dataclass
class SlamConfig:
    dataset_sequence: Union[int, str] = 9
    adaptation: bool = True
    adaptation_epochs: int = 5
    min_distance: float = 0.2
    start_frame: int = 0
    logging: bool = True
    # periodic trajectory/metric plots + pose-graph OBJ export inside the
    # loop (reference slam/slam.py:272-278 does this every 100 steps);
    # 0 disables
    plot_frequency: int = 100
    do_loop_closures: bool = True
    keyframe_frequency: int = 5
    lc_distance_poses: int = 150
    # dual-network expert/generalist mode (BASELINE config rung 3): the
    # expert adapts every frame; the generalist consolidates on replay-only
    # batches every `generalist_interval` frames
    use_expert: bool = False
    generalist_interval: int = 5
    generalist_steps: int = 1
    # CoVIO async mode (rung 5): decouple inference from adaptation — the
    # pose for frame t comes from the newest COMPLETED adapted parameters
    # instead of blocking on frame t's update
    async_adaptation: bool = False
    # Readback pipelining: defer all per-frame host readbacks (pose,
    # embedding, losses) up to N frames so the host->device sync latency
    # overlaps the next frames' device compute.  0 (default) = read back
    # every frame like the reference.  N>0 trades exactness of the host
    # state for throughput: replay-buffer admissions, pose-graph edges and
    # loop-closure searches for frame t happen while frame t+1..t+N
    # dispatch, so replay draws and LC candidate sets lag <=N frames (the
    # adapted WEIGHTS do not lag — the device chain is unaffected).  See
    # Slam._retire.
    pipeline_depth: int = 0
    config_file: Optional[Path] = None


@dataclasses.dataclass
class Config:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    depth_pose: DepthPoseConfig = dataclasses.field(default_factory=DepthPoseConfig)
    replay_buffer: ReplayBufferConfig = dataclasses.field(
        default_factory=ReplayBufferConfig
    )
    loop_closure: LoopClosureConfig = dataclasses.field(
        default_factory=LoopClosureConfig
    )
    slam: SlamConfig = dataclasses.field(default_factory=SlamConfig)
