"""Adaptation state and optimizer.

Counterpart of `tpuslam/train/state.py`.  Online adaptation runs Adam over
the decoders only: the encoders are frozen, and are simply absent from the
optimizer (the JAX package masks them with `set_to_zero`).  optax `adam`
(b1 0.9, b2 0.999, eps 1e-8, eps_root 0) equals `torch.optim.Adam` up to
rounding.  The optimizer updates the parameters in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpuslam_torch.models.depth_pose import DepthPoseNet


@dataclasses.dataclass
class TrainState:
    model: DepthPoseNet
    optimizer: torch.optim.Optimizer
    rng: Optional[torch.Generator]  # identity tie-break noise; None turns it off
    step: int = 0


def make_adapt_optimizer(
    model: DepthPoseNet, learning_rate: float = 1e-4, depth_lr_scale: float = 1.0
) -> torch.optim.Adam:
    """Adam over the decoders: the pose decoder at `learning_rate`, the depth
    decoder at `learning_rate * depth_lr_scale` (0 freezes it online)."""
    groups = [{"params": list(model.pose_decoder.parameters()), "lr": learning_rate}]
    if depth_lr_scale != 0.0:
        groups.append({"params": list(model.depth_decoder.parameters()),
                       "lr": learning_rate * depth_lr_scale})
    return torch.optim.Adam(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def make_train_state(
    model: DepthPoseNet, optimizer: torch.optim.Optimizer, seed: Optional[int] = 0
) -> TrainState:
    """`seed` seeds the tie-break noise generator; None turns the noise off."""
    rng = None
    if seed is not None:
        device = next(model.parameters()).device
        rng = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, rng=rng)
