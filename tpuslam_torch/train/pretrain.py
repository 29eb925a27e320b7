"""Offline pretraining loop (the reference `DepthPosePrediction.train`).

Counterpart of `tpuslam/train/pretrain.py`: epochs over a shuffled training
set, one `train_step` per batch (full forward / backward, batch norm in
train mode, Adam over every parameter), StepLR x0.1 every
`scheduler_step_size` epochs, periodic checkpoints, the validation loss and
the depth error after each epoch, and the best epoch marked in
`models/best.yaml`.

A background thread stacks the next batches as numpy arrays (`Prefetcher`);
the training thread copies each to the device.  `batches_from` draws the
same shuffled order from the same numpy generator as the JAX package's.

`dp_devices` N > 1 trains data-parallel: each of the N ranks of an
initialised process group (`tpuslam_torch.parallel.make_process_group`)
runs a `Pretrainer` with the same arguments, draws the same batches, and
steps on its slice of each (`make_dp_train_step`: sync-BN, averaged
gradients and losses).  Rank 0 alone validates, saves, marks the best epoch
and prints.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpuslam_torch import resolve_device
from tpuslam_torch.checkpoint.io import (
    latest_checkpoint,
    load_checkpoint,
    mark_best_checkpoint,
    save_checkpoint,
)
from tpuslam_torch.checkpoint.torch_import import init_encoders_from_imagenet
from tpuslam_torch.data.base import Prefetcher, Sample
from tpuslam_torch.eval.depth import calc_depth_error
from tpuslam_torch.geometry.depth import depth_to_disp
from tpuslam_torch.models.depth_pose import DepthPoseNet, init_depth_pose
from tpuslam_torch.parallel import make_dp_train_step, shard_batch
from tpuslam_torch.train.batch import FrameBatch, make_frame_batch
from tpuslam_torch.train.state import (
    make_pretrain_optimizer,
    make_train_state,
    set_learning_rate,
    steplr,
)
from tpuslam_torch.train.steps import LossConfig, eval_step, predict_depth_step, train_step


def stack_samples(samples: List[Sample]) -> Dict[str, np.ndarray]:
    """Samples -> the host arrays of one batch (`make_frame_batch`'s
    arguments); the mask only when every sample has one."""
    mask = None
    if all(s.mask is not None for s in samples):
        mask = np.stack([s.mask for s in samples])
    return dict(rgb=np.stack([s.rgb for s in samples]), K=np.stack([s.K for s in samples]),
                rel_dist=np.stack([s.rel_dist for s in samples]),
                rgb_aug=np.stack([s.aug for s in samples]), mask=mask)


def host_batches(dataset, batch_size: int, rng: np.random.Generator, shuffle: bool = True,
                 drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """The host arrays of each batch, in the JAX package's order: one
    `rng.shuffle` of the indices per pass."""
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_last:
            return
        yield stack_samples([dataset[int(i)] for i in idx])


def batches_from(dataset, batch_size: int, rng: np.random.Generator, shuffle: bool = True,
                 drop_last: bool = True, device="cuda") -> Iterable[FrameBatch]:
    """FrameBatches on `device` from a Sample dataset."""
    for arrays in host_batches(dataset, batch_size, rng, shuffle, drop_last):
        yield make_frame_batch(**arrays, device=device)


class Pretrainer:
    def __init__(
        self,
        *,
        height: int,
        width: int,
        scales=(0, 1, 2, 3),
        resnet_depth: int = 18,
        resnet_pose: int = 18,
        learning_rate: float = 1e-4,
        scheduler_step_size: int = 15,
        batch_size: int = 18,
        min_depth: float = 0.1,
        max_depth: Optional[float] = None,
        disparity_smoothness: float = 1e-3,
        velocity_loss_scaling: Optional[float] = 0.05,
        mask_dynamic: bool = False,
        log_path: Path = Path("./log/pretrain"),
        dp_devices: int = 1,
        seed: int = 42,
        pallas_warp: bool = False,
        encoder_weights: Optional[Path] = None,
        resnet_pretrained: bool = False,
        scale_prior_epochs: int = 0,
        scale_prior_weight: float = 0.01,
        dtype: str = "float32",
        device="cuda",
        model: Optional[DepthPoseNet] = None,
    ):
        """`model` trains the given networks in place (on `device`) instead
        of fresh ones drawn from `seed` and initialised from
        `encoder_weights`.  `dp_devices` > 1 needs an initialised process
        group of that size, and raises ValueError otherwise."""
        if dp_devices > 1:
            have = dist.get_world_size() if dist.is_initialized() else 1
            if have != dp_devices:
                raise ValueError(
                    f"dp_devices={dp_devices} needs a process group of {dp_devices} ranks "
                    f"(tpuslam_torch.parallel.make_process_group), have {have}")
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported dtype {dtype!r}")
        self.device = resolve_device(device)
        self.height, self.width = height, width
        self.batch_size = batch_size
        self.log_path = Path(log_path)
        self.lr_schedule = steplr(learning_rate, scheduler_step_size)
        self.epoch = 0
        self.rng = np.random.default_rng(seed)
        self.dp_devices = dp_devices
        self.rank = dist.get_rank() if dp_devices > 1 else 0

        if model is None:
            model = init_depth_pose(seed, resnet_depth=resnet_depth, resnet_pose=resnet_pose,
                                    scales=tuple(scales), device=self.device)
            init_encoders_from_imagenet(model, encoder_weights, required=resnet_pretrained)
        model.requires_grad_(True)
        # `pallas_warp` routes the warp through K1 (K1 without taps when
        # validating); every other kernel flag keeps its default, as in the
        # JAX package's pretrainer
        self.cfg = LossConfig(
            scales=tuple(scales),
            min_depth=min_depth,
            max_depth=max_depth,
            disparity_smoothness=disparity_smoothness,
            velocity_loss_scaling=velocity_loss_scaling,
            mask_dynamic=mask_dynamic,
            use_pallas_warp=pallas_warp,
            bf16_networks=dtype == "bfloat16",
        )
        # the anti-collapse disparity prior of the first `scale_prior_epochs`
        self.scale_prior_epochs = scale_prior_epochs
        self._cfg_prior = self.cfg._replace(scale_prior_weight=scale_prior_weight)
        self.state = make_train_state(model, make_pretrain_optimizer(model, learning_rate),
                                      seed=seed)
        self._dp_step = self._dp_cfg = None

    def _epoch_cfg(self) -> LossConfig:
        return self._cfg_prior if self.epoch <= self.scale_prior_epochs else self.cfg

    def _batch(self, arrays: Dict[str, np.ndarray]) -> FrameBatch:
        return make_frame_batch(**arrays, device=self.device)

    def _step(self, batch: FrameBatch) -> Dict[str, torch.Tensor]:
        cfg = self._epoch_cfg()
        if self.dp_devices > 1:
            if cfg is not self._dp_cfg:  # the prior's epochs have ended
                self._dp_step = make_dp_train_step(self.state.model, cfg)
                self._dp_cfg = cfg
            return self._dp_step(self.state, shard_batch(batch, self.rank, self.dp_devices))
        return train_step(self.state, cfg, batch)

    def train_epoch(self, dataset, progress: bool = True) -> float:
        """One pass over `dataset`; the loss is read (a host sync) every 25
        steps, and a non-finite one raises.  Returns the mean of the losses
        read, or the last step's loss."""
        self.epoch += 1
        set_learning_rate(self.state.optimizer, self.lr_schedule(self.epoch))
        losses, step_losses = [], None
        for i, arrays in enumerate(Prefetcher(host_batches(dataset, self.batch_size, self.rng))):
            step_losses = self._step(self._batch(arrays))
            if (i + 1) % 25 == 0:
                loss = float(step_losses["loss"])
                if not np.isfinite(loss):
                    raise RuntimeError(f"NaN loss at epoch {self.epoch} step {i + 1}")
                losses.append(loss)
                if progress and self.rank == 0:
                    print(f"epoch {self.epoch} step {i + 1}: loss={loss:.4f}")
        if step_losses is None:
            raise ValueError(f"the training split ({len(dataset)} samples) holds no batch of "
                             f"{self.batch_size}")
        if not losses:
            losses.append(float(step_losses["loss"]))
        return float(np.mean(losses))

    def validate(self, dataset, max_batches: Optional[int] = None) -> float:
        """Mean loss over the split (or its first `max_batches` batches),
        summed on the device and read once.  A split smaller than one batch
        is evaluated as one batch padded by cycling its samples."""
        total, count = None, 0
        for i, arrays in enumerate(host_batches(dataset, self.batch_size, self.rng,
                                                shuffle=False)):
            if max_batches is not None and i >= max_batches:
                break
            loss = eval_step(self.state.model, self.cfg, self._batch(arrays))[0]["loss"]
            total = loss if total is None else total + loss
            count += 1
        if count == 0:
            n = len(dataset)
            if n == 0:
                print("WARNING: validate(): empty val dataset — returning nan")
                return float("nan")
            print(f"WARNING: validate(): val split ({n} samples) smaller than batch_size "
                  f"({self.batch_size}) — evaluating one batch padded by cycling samples")
            arrays = stack_samples([dataset[i % n] for i in range(self.batch_size)])
            total = eval_step(self.state.model, self.cfg, self._batch(arrays))[0]["loss"]
            count = 1
        return float(total) / count

    def _depth(self, image: np.ndarray) -> torch.Tensor:
        """Depth (1, H, W, 1) of one NHWC float image."""
        image = torch.from_numpy(np.ascontiguousarray(image[None], np.float32)).to(self.device)
        depth, _ = predict_depth_step(self.state.model, image, self.cfg.min_depth,
                                      self.cfg.max_depth, self.cfg.bf16_networks)
        return depth

    def compute_depth_error(self, dataset, max_samples: Optional[int] = None) -> Dict[str, float]:
        """Median-scaled depth metrics over the samples with ground-truth
        depth (the whole split, or its first `max_samples`); the
        predictions come back in one copy."""
        n = len(dataset)
        if max_samples is not None and n > max_samples:
            print(f"compute_depth_error: truncating {n} -> {max_samples} samples")
            n = max_samples
        preds, gts = [], []
        for i in range(n):
            s = dataset[i]
            if s.depth is None:
                continue
            preds.append(self._depth(s.rgb[1])[..., 0])
            gts.append(s.depth)
        if not preds:
            return {}
        metrics = [calc_depth_error(pred, gt, min_depth=self.cfg.min_depth,
                                    max_depth=self.cfg.max_depth)
                   for pred, gt in zip(torch.cat(preds).cpu().numpy(), gts)]
        return {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}

    def load(self, folder: Optional[Path] = None) -> "Pretrainer":
        """Resume from a checkpoint folder (the latest under `log_path` by
        default): the networks with their BN statistics, Adam's state where
        it is stored and fits, the epoch and the step."""
        folder = folder or latest_checkpoint(self.log_path)
        if folder is None:
            raise FileNotFoundError(f"no checkpoints under {self.log_path}")
        meta = load_checkpoint(folder, self.state.model, self.state.optimizer)
        self.epoch = int(meta.get("epoch", 0))
        self.state.step = int(meta.get("step", self.state.step))
        return self

    def save(self, config_yaml: Optional[str] = None) -> Optional[Path]:
        """The checkpoint folder of this epoch (None on a rank other than 0,
        which writes nothing)."""
        if self.rank != 0:
            return None
        return save_checkpoint(self.log_path, epoch=self.epoch, model=self.state.model,
                               optimizer=self.state.optimizer, meta={"step": self.state.step},
                               config_yaml=config_yaml)

    def save_depth_panel(self, dataset, sample_index: int = 0) -> Optional[Path]:
        """RGB + predicted-depth panel of one sample under
        <log_path>/panels/epoch_{N}.png."""
        image = dataset[sample_index].rgb[1]
        depth = self._depth(image)[0, ..., 0].cpu().numpy()
        out = self.log_path / "panels" / f"epoch_{self.epoch:03d}.png"
        try:
            from tpuslam_torch.viz.plots import save_depth_panel

            return save_depth_panel(image, depth, out)
        except ImportError as e:
            print(f"plotting skipped: {e}")
            return None

    def save_prediction(self, dataset, max_samples: int = 4, logger=None) -> List[Path]:
        """Per-sample prediction panels (RGB, disparity, depth, and the
        ground truth with its abs-rel where the dataset has it) under
        <log_path>/prediction/val_depth_{epoch:03}/, and the strip for
        `logger.log_image`."""
        rgbs, disps, depths, gts, indices = [], [], [], [], []
        for i in range(min(len(dataset), max_samples)):
            s = dataset[i]
            d = self._depth(s.rgb[1])[0, ..., 0].cpu().numpy()
            rgbs.append(s.rgb[1])
            depths.append(d)
            # the sigmoid disparity, recovered through the depth mapping
            disps.append(np.asarray(depth_to_disp(np.maximum(d, 1e-6), self.cfg.min_depth,
                                                  self.cfg.max_depth)))
            gts.append(s.depth)
            indices.append(i)
        if not rgbs:
            return []
        folder = self.log_path / "prediction" / f"val_depth_{self.epoch:03d}"
        try:
            from tpuslam_torch.viz.plots import save_prediction_panels

            paths, strip = save_prediction_panels(
                rgbs, depths, indices, folder, disps=disps,
                gt_depths=gts if all(g is not None for g in gts) else None)
        except ImportError as e:
            print(f"plotting skipped: {e}")
            return []
        if logger is not None and strip is not None:
            logger.log_image("pred_depth", strip, step=self.epoch)
        return paths

    def fit(
        self,
        train_dataset,
        val_dataset=None,
        num_epochs: int = 25,
        save_frequency: int = -1,
        validate: bool = True,
        depth_error: bool = False,
        log_fn: Optional[Callable[[Dict], None]] = None,
        save_panels: bool = False,
        save_val_depth: int = 0,
        image_logger=None,
        val_batches: Optional[int] = None,
        monitor: Optional[str] = None,
    ) -> "Pretrainer":
        """Train for `num_epochs`, tracking the best epoch by `monitor`
        (abs_rel with `depth_error`, else validation_loss when validating,
        else training_loss; lower is better).  Each improvement saves the
        checkpoint and marks it in models/best.yaml; the final model is
        always saved.  With `dp_devices` > 1 the ranks other than 0 only
        train."""
        if monitor is None:
            if depth_error and val_dataset is not None:
                monitor = "abs_rel"
            elif validate and val_dataset is not None:
                monitor = "validation_loss"
            else:
                monitor = "training_loss"
        best = float("inf")
        for _ in range(num_epochs):
            train_loss = self.train_epoch(train_dataset)
            if self.rank != 0:
                continue
            record = {"epoch": self.epoch, "training_loss": train_loss}
            if validate and val_dataset is not None:
                record["validation_loss"] = self.validate(val_dataset, max_batches=val_batches)
            if depth_error and val_dataset is not None:
                record.update(self.compute_depth_error(val_dataset))
            value = record.get(monitor)
            if value is not None and np.isfinite(value) and value < best:
                best = float(value)
                self.save()
                mark_best_checkpoint(self.log_path, self.epoch, monitor, best)
                record["best"] = f"{monitor}*"
            panels_from = val_dataset if val_dataset is not None else train_dataset
            if save_panels:
                self.save_depth_panel(panels_from)
            if save_val_depth > 0:
                self.save_prediction(panels_from, max_samples=save_val_depth,
                                     logger=image_logger)
            if save_frequency > 0 and self.epoch % save_frequency == 0:
                self.save()
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in record.items()))
            if log_fn is not None:
                log_fn(record)
        self.save()
        return self
