"""Train / adapt state and optimizers.

Counterpart of `tpuslam/train/state.py`.  Online adaptation runs Adam over
the decoders only: the encoders are frozen, and are simply absent from the
optimizer (the JAX package masks them with `set_to_zero`).  Pretraining
runs Adam over every parameter, its learning rate set per epoch by a
StepLR schedule from the host.  optax `adam` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0) equals `torch.optim.Adam` up to rounding.  The optimizer
updates the parameters in place.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, List, Optional

import torch

from tpuslam_torch.models.depth_pose import DepthPoseNet


@dataclasses.dataclass
class TrainState:
    model: DepthPoseNet
    optimizer: torch.optim.Optimizer
    rng: Optional[torch.Generator]  # identity tie-break noise; None turns it off
    step: int = 0
    # the CUDA graph of one adaptation iteration over this state's decoders
    # (`train.steps.IterationGraph`), and the key of the last adaptation
    graph: Any = None
    graph_key: Any = None


def steplr(base_lr: float, step_size: int, gamma: float = 0.1) -> Callable[[int], float]:
    """Per-epoch StepLR: lr(epoch) = base_lr * gamma^(epoch // step_size).
    The epoch counts from 1 (`Pretrainer.train_epoch` counts it up before it
    sets the rate), which is not `torch.optim.lr_scheduler.StepLR`'s
    indexing."""

    def schedule(epoch: int) -> float:
        return base_lr * (gamma ** (epoch // step_size))

    return schedule


def make_pretrain_optimizer(model: DepthPoseNet, learning_rate: float = 1e-4) -> torch.optim.Adam:
    """Adam over every parameter; `set_learning_rate` drives its rate."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, learning_rate: float) -> None:
    """Set the learning rate of every parameter group (the host-side epoch
    schedule)."""
    for group in optimizer.param_groups:
        group["lr"] = learning_rate


class ClippedAdam(torch.optim.Adam):
    """Adam after global-norm clipping, as `optax.chain(clip_by_global_norm,
    adam)`: a gradient whose norm g is at least `max_norm` is scaled by
    max_norm / g.  With `per_group` each parameter group is clipped on its
    own norm, else all groups on one."""

    def __init__(self, groups, max_norm: float, per_group: bool, **kwargs):
        super().__init__(groups, **kwargs)
        self.max_norm, self.per_group = max_norm, per_group

    @torch.no_grad()
    def step(self, closure=None):
        grads = [[p.grad for p in g["params"] if p.grad is not None]
                 for g in self.param_groups]
        for group in grads if self.per_group else [sum(grads, [])]:
            if not group:
                continue
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in group]))
            scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
            torch._foreach_mul_(group, scale)
        return super().step(closure)


def make_adapt_optimizer(
    model: DepthPoseNet, learning_rate: float = 1e-4, depth_lr_scale: float = 1.0,
    grad_clip_norm: Optional[float] = None,
) -> torch.optim.Adam:
    """Adam over the decoders: the pose decoder at `learning_rate`, the depth
    decoder at `learning_rate * depth_lr_scale` (0 freezes it online).

    `grad_clip_norm` clips the gradients' global norm before Adam: of both
    decoders together, or of each decoder on its own when `depth_lr_scale`
    splits the heads (the JAX package's `multi_transform`)."""
    groups = [{"params": list(model.pose_decoder.parameters()), "lr": learning_rate}]
    if depth_lr_scale != 0.0:
        groups.append({"params": list(model.depth_decoder.parameters()),
                       "lr": learning_rate * depth_lr_scale})
    adam = dict(lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if grad_clip_norm is None:
        return torch.optim.Adam(groups, **adam)
    return ClippedAdam(groups, grad_clip_norm, per_group=depth_lr_scale != 1.0, **adam)


def make_train_state(
    model: DepthPoseNet, optimizer: torch.optim.Optimizer, seed: Optional[int] = 0
) -> TrainState:
    """`seed` seeds the tie-break noise generator; None turns the noise off."""
    rng = None
    if seed is not None:
        device = next(model.parameters()).device
        rng = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, rng=rng)


def clone_train_state(state: TrainState) -> TrainState:
    """A copy of `state` that can be updated without touching it: the
    decoders, the Adam state and the tie-break generator are copied (the
    clone's optimizer holds the clone's parameters).  The frozen encoders
    are shared with `state`, because nothing writes them.  The clone has no
    CUDA graph and has not adapted yet."""
    src = state.model
    memo = {id(src.depth_encoder): src.depth_encoder, id(src.pose_encoder): src.pose_encoder}
    model, optimizer = copy.deepcopy((src, state.optimizer), memo)
    rng = None
    if state.rng is not None:
        rng = torch.Generator(device=state.rng.device)
        rng.set_state(state.rng.get_state())
    return TrainState(model=model, optimizer=optimizer, rng=rng, step=state.step)


def train_state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The tensors `clone_train_state` copies: the decoders' parameters,
    buffers and gradients, and the optimizer's state."""
    decoders = (state.model.depth_decoder, state.model.pose_decoder)
    out = [t for m in decoders for t in (*m.parameters(), *m.buffers())]
    out += [p.grad for m in decoders for p in m.parameters() if p.grad is not None]
    out += [v for st in state.optimizer.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]
    return out
