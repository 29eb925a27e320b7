"""Checkpoint save / load with the JAX package's folder contract.

Counterpart of `tpuslam/checkpoint/io.py`.  A checkpoint is

  <log_path>/models/weights_{epoch:03d}/
    model.pt        # DepthPoseNet.state_dict() (monodepth2 key names)
    optimizer.pt    # Adam's state_dict() (optional)
    meta.yaml       # epoch, and what the caller adds
  <log_path>/config.yaml   # the run's config (optional)
  <log_path>/models/best.yaml   # the epoch marked best (optional)

`load_checkpoint` also reads a folder that the JAX package wrote
(`params.msgpack`, `batch_stats.msgpack`, flax msgpack): its variables go
through `checkpoint/from_jax.py`.  Its optax `opt_state.msgpack` is not
turned into Adam state: the optimizer starts fresh, with the line the JAX
package prints when its stored optimizer does not fit.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch
import yaml

from tpuslam_torch.checkpoint.from_jax import load_jax_variables
from tpuslam_torch.checkpoint.msgpack_reader import load_flax_variables
from tpuslam_torch.models.depth_pose import DepthPoseNet

OPTIMIZER_MISMATCH = "checkpoint: optimizer state mismatch — starting fresh"


def save_checkpoint(
    log_path: Path,
    epoch: int,
    model: DepthPoseNet,
    optimizer: Optional[torch.optim.Optimizer] = None,
    meta: Optional[Dict] = None,
    config_yaml: Optional[str] = None,
) -> Path:
    folder = Path(log_path) / "models" / f"weights_{epoch:03d}"
    folder.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               folder / "model.pt")
    if optimizer is not None:
        torch.save(optimizer.state_dict(), folder / "optimizer.pt")
    meta = dict(meta or {})
    meta["epoch"] = epoch
    with open(folder / "meta.yaml", "w") as f:
        yaml.safe_dump(meta, f)
    if config_yaml is not None:
        (folder.parent.parent / "config.yaml").write_text(config_yaml)
    return folder


def load_checkpoint(
    folder: Path,
    model: DepthPoseNet,
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> Dict:
    """Load a checkpoint folder into `model` (and `optimizer`, when given
    and stored) in place, so that an optimizer built on the parameters
    stays valid.  Returns the folder's meta.  A stored optimizer that does
    not fit, or an optax one, leaves `optimizer` as it was."""
    folder = Path(folder)
    if (folder / "model.pt").exists():
        saved = torch.load(folder / "model.pt", map_location="cpu", weights_only=True)
        model.load_state_dict(saved)
        opt_path = folder / "optimizer.pt"
    else:
        params, batch_stats = load_flax_variables(folder)
        load_jax_variables(model, params, batch_stats)
        opt_path = folder / "opt_state.msgpack"
    if optimizer is not None and opt_path.exists():
        try:
            if opt_path.suffix != ".pt":
                raise ValueError("optax state")
            optimizer.load_state_dict(torch.load(opt_path, map_location="cpu",
                                                 weights_only=True))
        except Exception:
            print(OPTIMIZER_MISMATCH)
    meta = {}
    meta_path = folder / "meta.yaml"
    if meta_path.exists():
        with open(meta_path) as f:
            meta = yaml.safe_load(f) or {}
    return meta


def latest_checkpoint(log_path: Path) -> Optional[Path]:
    models = Path(log_path) / "models"
    if not models.exists():
        return None
    candidates = sorted(models.glob("weights_*"))
    return candidates[-1] if candidates else None


def mark_best_checkpoint(log_path: Path, epoch: int, monitor: str, value: float) -> None:
    """Record which epoch's checkpoint is the best so far (models/best.yaml)."""
    models = Path(log_path) / "models"
    models.mkdir(parents=True, exist_ok=True)
    with open(models / "best.yaml", "w") as f:
        yaml.safe_dump({"epoch": epoch, "monitor": monitor, "value": float(value)}, f)

