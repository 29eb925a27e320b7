"""Data-parallel pretraining, one process per card.

Counterpart of `tpuslam/parallel/mesh.py`, where one program runs a
`shard_map` step over a device mesh.  Here each rank of a
`torch.distributed` process group is a process with its own card (NCCL), or
with the CPU (gloo): `make_process_group` joins the group, `shard_batch`
keeps the rank's slice of the global batch, and the step of
`make_dp_train_step` does what the JAX step does inside its mesh:

- every rank holds the same networks and Adam state (the same seed), and
  steps on its slice of the batch, its sample weights scaled by the world
  size so that the mean over the ranks is the global weighted mean;
- batch norm normalises with the statistics of the global batch (sync-BN:
  `models/resnet.py::BatchNorm` with its `process_group` set for the
  step's forward, and unset after it), and its
  running statistics move by flax's rule with the global mean and biased
  variance, the same on every rank;
- the gradients and the losses are averaged over the ranks (all-reduce);
- Adam then takes the same step on every rank;
- the tie-break noise is drawn from each rank's generator, which is in the
  same state on every rank, and is broadcast over the batch, as the JAX
  step draws it from its replicated key;
- TF32 is off for the step, as in `train_step`.

So the step equals the single-process `train_step` on the whole batch up to
the order of its sums (`tests/test_torch_port_parallel.py`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import socket
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from tpuslam_torch import full_fp32, resolve_device
from tpuslam_torch.models.resnet import BatchNorm
from tpuslam_torch.train.batch import FrameBatch
from tpuslam_torch.train.state import TrainState
from tpuslam_torch.train.steps import LossConfig, forward


def local_init_method() -> str:
    """A `tcp://localhost:<port>` address on a port that is free now, for
    the store of a process group whose ranks run on this host."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return f"tcp://localhost:{sock.getsockname()[1]}"


def make_process_group(world_size: int, rank: int, device, init_method: str,
                       backend: Optional[str] = None) -> torch.device:
    """Join the default process group as `rank` of `world_size` at
    `init_method` and return this rank's device: card `rank` over NCCL, or
    the CPU over gloo with `device="cpu"`.  `backend="gloo"` puts several
    ranks on one card (NCCL refuses two ranks on one device)."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return device


def shard_batch(batch: FrameBatch, rank: int, world_size: int) -> FrameBatch:
    """This rank's slice of the global batch along its leading axis (the
    batch size must be a multiple of the world size)."""
    B = batch.batch_size
    if B % world_size:
        raise ValueError(f"batch of {B} does not split over {world_size} ranks")
    n = B // world_size
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name)[rank * n:(rank + 1) * n]
        for f in dataclasses.fields(batch) if getattr(batch, f.name) is not None})


@contextlib.contextmanager
def sync_batch_norm(model: torch.nn.Module, group) -> Iterator[None]:
    """Inside the block, every batch norm of `model` normalises over the
    ranks of `group` in train mode; after it, each normalises as before
    (its backward keeps the group it ran its forward with)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.process_group for m in norms]
    for m in norms:
        m.process_group = group
    try:
        yield
    finally:
        for m, g in zip(norms, saved):
            m.process_group = g


def make_dp_train_step(model: torch.nn.Module, cfg: LossConfig, group=None
                       ) -> Callable[[TrainState, FrameBatch], Dict[str, torch.Tensor]]:
    """The data-parallel pretraining step of this rank for a state holding
    `model`, whose batch norms it synchronises over `group` (the default
    process group when None): `step(state, shard)` takes the rank's slice
    of the global batch (`shard_batch`), updates the state in place exactly
    as every other rank does, and returns the losses of the global batch
    (detached, on the device)."""
    world = dist.get_world_size(group)
    group = group or dist.group.WORLD

    @full_fp32()
    def step(state: TrainState, batch: FrameBatch) -> Dict[str, torch.Tensor]:
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        batch = dataclasses.replace(batch, weights=batch.weights * world)
        with sync_batch_norm(model, group):
            losses, _ = forward(state.model, batch, cfg, train_bn=True, rng=state.rng)
        losses["loss"].backward()
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        opt.step()
        state.step += 1
        names = sorted(losses)
        values = torch.stack([losses[k].detach() for k in names])
        dist.all_reduce(values, group=group)
        values /= world
        return dict(zip(names, values.unbind()))

    return step
