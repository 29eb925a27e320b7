"""DepthPosePrediction facade: the reference's L2 interface on the port.

Counterpart of `tpuslam/predictor.py`: adaptation (`adapt`, with the
expert/online model pair of `use_online`), inference (`predict`,
`predict_from_image`, `predict_from_images` with its photometric probe,
`predict_pose`), the depth and pose metrics, checkpoints (`save_model`,
`load_model`, `load_online_model`, in the folders of `checkpoint/io.py`,
which also reads the JAX package's), and the import of a reference
`weights_NNN/` folder.  The warp of every step is routed by the `pallas_*`
flags of the config, as in `Slam`.

Pretraining (`train`) runs the port's `Pretrainer` on the facade's networks
(`use_wandb` logs each epoch's record to `log_path/metrics.jsonl` through
`MetricsLogger`, and to wandb where it is installed); `validate` is the
mean no-grad loss over a split.  ImageNet encoders come from a local
torchvision `.pth` (`encoder_weights`, `resnet_pretrained`).

Images are NHWC float32 in [0, 1] (numpy arrays or tensors); a single image
may omit the batch dimension.  Runs on the card unless `device="cpu"`.
"""
from __future__ import annotations

import copy
import dataclasses
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from tpuslam_torch import full_fp32, resolve_device
from tpuslam_torch.checkpoint.io import latest_checkpoint, load_checkpoint, save_checkpoint
from tpuslam_torch.checkpoint.torch_import import init_encoders_from_imagenet
from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig
from tpuslam_torch.data.base import Sample
from tpuslam_torch.eval.depth import _resize_bilinear, calc_depth_error
from tpuslam_torch.eval.trajectory import rotation_error, translation_error
from tpuslam_torch.geometry.camera import backproject_depth, pixel_grid, project_3d
from tpuslam_torch.geometry.se3 import se3_inverse
from tpuslam_torch.losses.photometric import reprojection_loss
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.ops.warp import warp_two_kernel
from tpuslam_torch.train.batch import FrameBatch, make_frame_batch, pad_batch
from tpuslam_torch.train.pretrain import Pretrainer, host_batches
from tpuslam_torch.train.state import TrainState, make_adapt_optimizer, make_train_state
from tpuslam_torch.train.steps import (
    adapt_step,
    eval_step,
    loss_config,
    predict_depth_step,
    predict_pose_step,
)
from tpuslam_torch.utils.profiling import MetricsLogger


def _untrained_warning(trained: bool) -> None:
    if not trained:
        warnings.warn("The model has not been trained yet.", RuntimeWarning)


class DepthPosePrediction:
    def __init__(
        self,
        dataset_config: DatasetConfig,
        config: DepthPoseConfig,
        use_online: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.dataset_config = dataset_config
        self.config = config
        self.height = dataset_config.height
        self.width = dataset_config.width
        self.min_depth = config.min_depth
        self.max_depth = config.max_depth
        self.batch_size = config.batch_size
        self.load_weights_folder = config.load_weights_folder
        self.log_path = Path(config.log_path)
        self.is_trained = False
        self.epoch = 0

        # adaptation and inference read no dynamic-object mask (as in the JAX
        # package); `mask_dynamic` applies to `train` only
        self.loss_cfg = loss_config(config)._replace(mask_dynamic=False)
        self.model = init_depth_pose(0, resnet_depth=config.resnet_depth,
                                     resnet_pose=config.resnet_pose,
                                     scales=tuple(config.scales), device=self.device)
        init_encoders_from_imagenet(self.model, config.encoder_weights,
                                    required=config.resnet_pretrained)
        self.model.requires_grad_(False)
        self.model.depth_decoder.requires_grad_(True)
        self.model.pose_decoder.requires_grad_(True)
        self.state = self._train_state(self.model)
        self.use_online = use_online
        self.online_state = (self._train_state(copy.deepcopy(self.model))
                             if use_online else None)

    def _train_state(self, model) -> TrainState:
        c = self.config
        return make_train_state(
            model, make_adapt_optimizer(model, c.learning_rate, c.adapt_depth_lr_scale))

    def _state(self, use_online: bool) -> TrainState:
        return self.online_state if use_online and self.online_state is not None else self.state

    def _batchify(self, image) -> torch.Tensor:
        image = torch.as_tensor(np.asarray(image, np.float32) if not torch.is_tensor(image)
                                else image).to(self.device, torch.float32)
        return image[None] if image.dim() == 3 else image

    # ------------------------------------------------------------ training
    def train(
        self,
        train_dataset,
        val_dataset=None,
        validate: bool = False,
        depth_error: bool = False,
        use_wandb: bool = False,
        num_epochs: Optional[int] = None,
    ) -> None:
        """Offline pretraining (reference train()) of the facade's networks,
        encoders included, in place, by a `Pretrainer` built from the config.
        Afterwards adaptation starts from the trained networks with a fresh
        Adam over the decoders.  (The JAX package's train() hands its
        pretrainer the adaptation state, whose optax state has no learning
        rate to set, and fails at the first epoch.)"""
        c = self.config
        logger = None
        if use_wandb:
            logger = MetricsLogger(self.log_path / "metrics.jsonl", use_wandb=True)
        trainer = Pretrainer(
            height=self.height, width=self.width, scales=c.scales,
            learning_rate=c.learning_rate, scheduler_step_size=c.scheduler_step_size,
            batch_size=c.batch_size, min_depth=c.min_depth, max_depth=c.max_depth,
            disparity_smoothness=c.disparity_smoothness,
            velocity_loss_scaling=c.velocity_loss_scaling, mask_dynamic=c.mask_dynamic,
            log_path=c.log_path, dp_devices=c.dp_devices,
            scale_prior_epochs=c.scale_prior_epochs, scale_prior_weight=c.scale_prior_weight,
            dtype=c.dtype, device=self.device, model=self.model,
        )
        try:
            trainer.fit(
                train_dataset, val_dataset,
                num_epochs=num_epochs if num_epochs is not None else c.num_epochs,
                save_frequency=c.save_frequency, validate=validate, depth_error=depth_error,
                log_fn=None if logger is None else logger.log,
                save_val_depth=(max(1, c.save_val_depth_batches) * c.batch_size
                                if c.save_val_depth else 0),
                image_logger=logger,
            )
        finally:
            self.model.requires_grad_(False)
            self.model.depth_decoder.requires_grad_(True)
            self.model.pose_decoder.requires_grad_(True)
        self.state = self._train_state(self.model)
        self.epoch = trainer.epoch
        self.is_trained = True

    def validate(self, dataset, max_batches: Optional[int] = None) -> float:
        """Mean no-grad loss over the split's batches (or its first
        `max_batches`); NaN when it holds no full batch."""
        _untrained_warning(self.is_trained)
        losses = []
        for i, arrays in enumerate(host_batches(dataset, self.batch_size,
                                                np.random.default_rng(0), shuffle=False)):
            if max_batches is not None and i >= max_batches:
                break
            batch = make_frame_batch(**arrays, device=self.device)
            losses.append(eval_step(self.model, self.loss_cfg, batch)[0]["loss"])
        return float(torch.stack(losses).mean()) if losses else float("nan")

    def adapt(
        self,
        online_batch: FrameBatch,
        training_batch: Optional[FrameBatch] = None,
        steps: int = 1,
        use_online: bool = False,
        online_loss_weight: Optional[float] = None,
        online_index: int = 0,
    ):
        """Online adaptation (reference adapt()): K update iterations when
        training data is given, otherwise a no-grad eval of `online_batch`.
        `online_loss_weight` re-weights the online sample and spreads the
        rest uniformly over the replay samples.  Returns (outputs, losses)
        of the last iteration's forward, without the warped images."""
        state = self._state(use_online)
        if training_batch is None:
            losses, outputs = eval_step(state.model, self.loss_cfg, online_batch)
            return outputs, losses
        B = training_batch.batch_size
        if online_loss_weight is not None and B > 1:
            w = np.full((B,), (1.0 - online_loss_weight) / (B - 1), np.float32)
            w[online_index] = online_loss_weight
            training_batch = dataclasses.replace(
                training_batch, weights=torch.from_numpy(w).to(training_batch.weights.device))
        training_batch = pad_batch(training_batch, self.batch_size)
        losses, outputs = adapt_step(state, self.loss_cfg, training_batch, num_steps=steps)
        return outputs, losses

    # ---------------------------------------------------------- prediction
    def predict(self, batch: FrameBatch):
        """Full no-grad forward on a batch (reference predict())."""
        _untrained_warning(self.is_trained)
        _, outputs = eval_step(self.model, self.loss_cfg, batch)
        return outputs

    def _depth(self, image, max_depth) -> torch.Tensor:
        depth, _ = predict_depth_step(self.model, image, self.min_depth, max_depth,
                                      self.loss_cfg.bf16_networks)
        return depth

    def predict_from_image(self, image, as_numpy: bool = True):
        """Single image -> depth map (H, W)."""
        _untrained_warning(self.is_trained)
        depth = self._depth(self._batchify(image), self.max_depth)
        return depth[0, ..., 0].cpu().numpy() if as_numpy else depth

    def predict_from_images(
        self,
        image_0,
        image_1,
        as_numpy: bool = True,
        return_loss: bool = False,
        camera_matrix=None,
        inv_camera_matrix=None,
        relative_distance=None,
    ):
        """Two images -> (depth_0, depth_1, relative pose).

        With `return_loss=True` (calibration given) also the scale-0
        photometric loss of warping image_0 into image_1's frame, the
        reference's drift probe; the warp is K2's forward kernel in f32."""
        _untrained_warning(self.is_trained)
        i0, i1 = self._batchify(image_0), self._batchify(image_1)
        d0 = self._depth(i0, self.max_depth)
        d1 = self._depth(i1, self.max_depth)
        T, _ = predict_pose_step(self.model, i0, i1, self.loss_cfg.bf16_networks)
        out = (d0, d1, T)
        if as_numpy:
            out = (d0[0, ..., 0].cpu().numpy(), d1[0, ..., 0].cpu().numpy(), T[0].cpu().numpy())
        if not return_loss:
            return out
        if camera_matrix is None or inv_camera_matrix is None:
            raise ValueError("return_loss requires camera matrices")
        return out + (self._photometric_probe(i0, i1, d1, T, camera_matrix, inv_camera_matrix,
                                              relative_distance),)

    @torch.no_grad()
    @full_fp32()
    def _photometric_probe(self, i0, i1, d1, T, camera_matrix, inv_camera_matrix,
                           relative_distance) -> Dict[str, float]:
        H, W = i1.shape[1:3]

        def mat(m):
            return torch.as_tensor(np.asarray(m, np.float32).reshape(1, 4, 4), device=self.device)

        # warp image_0 (frame -1) into image_1's frame with T(0, -1) = inv(T)
        pts = backproject_depth(d1[..., 0], mat(inv_camera_matrix),
                                pixel_grid(H, W, device=self.device))
        coords = project_3d(pts, mat(camera_matrix), se3_inverse(T), H, W)
        warped = warp_two_kernel(i0.contiguous(), coords.contiguous())
        reproj = reprojection_loss(warped, i1)
        ident = reprojection_loss(i0, i1)
        photometric = float(torch.minimum(reproj, ident).mean())
        losses = {"reprojection_loss/scale_0": photometric, "loss": photometric}
        if relative_distance is not None:
            rel = torch.as_tensor(np.asarray(relative_distance, np.float32), device=self.device)
            losses["velocity_loss"] = float(
                (torch.linalg.vector_norm(T[0, :3, 3]) - rel.abs()).abs().mean())
        return losses

    def predict_pose(self, image_0, image_1, as_numpy: bool = True, use_online: bool = False):
        """Relative pose (4, 4) and the placeholder covariance (6, 6)."""
        _untrained_warning(self.is_trained)
        T, cov = predict_pose_step(self._state(use_online).model, self._batchify(image_0),
                                   self._batchify(image_1), self.loss_cfg.bf16_networks)
        if as_numpy:
            return T[0].cpu().numpy(), cov.cpu().numpy()
        return T, cov

    # ------------------------------------------------------------- metrics
    def compute_depth_error(
        self, dataset, median_scaling: bool = True,
        max_samples: Optional[int] = None, print_results: bool = True,
    ) -> Dict[str, float]:
        """Monodepth2-style depth metrics over the dataset (or its first
        `max_samples`), per sample, averaged; depth always through min_depth
        with no max_depth, like the reference; the median-scaling ratio is
        reported as med_scaling.  The predictions come back in one copy."""
        n = len(dataset)
        if max_samples is not None and n > max_samples:
            print(f"compute_depth_error: truncating {n} -> {max_samples} samples")
            n = max_samples
        preds, gts = [], []
        for i in range(n):
            s: Sample = dataset[i]
            if s.depth is None:
                continue
            preds.append(self._depth(self._batchify(s.rgb[1]), None)[..., 0])
            gts.append(s.depth)
        if not preds:
            return {}
        metrics, ratios = [], []
        for pred, gt in zip(torch.cat(preds).cpu().numpy(), gts):
            if median_scaling:
                valid = gt > self.min_depth
                if valid.any():
                    pr = _resize_bilinear(pred, *gt.shape)
                    ratios.append(float(np.median(gt[valid]) / np.median(pr[valid])))
            metrics.append(calc_depth_error(pred, gt, median_scaling=median_scaling,
                                            min_depth=self.min_depth, max_depth=self.max_depth))
        out = {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}
        if median_scaling and ratios:
            out["med_scaling"] = float(np.median(ratios))
        if print_results:
            print(" ".join(f"{k}={v:.4f}" for k, v in out.items()))
        return out

    def compute_pose_error(
        self, dataset, max_samples: Optional[int] = None, print_results: bool = True,
    ) -> Dict[str, float]:
        """Mean frame-to-frame translation and rotation error against the
        ground truth; the poses come back in one copy."""
        n = len(dataset)
        if max_samples is not None and n > max_samples:
            print(f"compute_pose_error: truncating {n} -> {max_samples} samples")
            n = max_samples
        Ts, gt_poses = [], []
        for i in range(n):
            s: Sample = dataset[i]
            if s.rel_pose is None:
                continue
            T, _ = self.predict_pose(s.rgb[1], s.rgb[2], as_numpy=False)
            Ts.append(T[:1])
            gt_poses.append(s.rel_pose)
        terrs, rerrs = [], []
        for T, rel_pose in zip(torch.cat(Ts).cpu().numpy() if Ts else [], gt_poses):
            err = np.linalg.inv(rel_pose) @ np.linalg.inv(T)
            terrs.append(translation_error(err))
            rerrs.append(rotation_error(err))
        out = {
            "trans_error": float(np.mean(terrs)) if terrs else float("nan"),
            "rot_error": float(np.mean(rerrs)) if rerrs else float("nan"),
        }
        if print_results:
            print(f"pose error: {out}")
        return out

    # --------------------------------------------------------- persistence
    def save_model(self) -> Path:
        """The networks and Adam's state as checkpoint `epoch` under `log_path`."""
        return save_checkpoint(self.log_path, epoch=self.epoch, model=self.state.model,
                               optimizer=self.state.optimizer)

    def load_model(self, load_optimizer: bool = True, folder: Optional[Path] = None):
        """Load `folder`, else `load_weights_folder`, else the latest
        checkpoint under `log_path`, in place; Adam's state too with
        `load_optimizer` where it is stored and fits."""
        folder = folder or self.load_weights_folder
        if folder is None:
            folder = latest_checkpoint(self.log_path)
        if folder is None or not Path(folder).exists():
            print(f"Cannot find weights folder: {folder}")
            return
        meta = load_checkpoint(folder, self.state.model,
                               self.state.optimizer if load_optimizer else None)
        self.epoch = int(meta.get("epoch", 0))
        self.is_trained = True

    def load_online_model(self, load_optimizer: bool = True, folder: Optional[Path] = None):
        """Load the online (expert) networks from the same checkpoint."""
        if self.online_state is None:
            raise RuntimeError("constructed with use_online=False")
        folder = folder or self.load_weights_folder
        load_checkpoint(folder, self.online_state.model,
                        self.online_state.optimizer if load_optimizer else None)

    def load_reference_checkpoint(self, weights_folder: Path):
        """Load a reference `weights_NNN/` folder: depth_encoder.pth,
        pose_encoder.pth (with or without the `resnet.` prefix),
        depth_decoder.pth and pose_decoder.pth.  The networks carry the
        monodepth2 key names, so each file loads into its module as it is;
        other entries of a file (image size, options) are ignored."""
        folder = Path(weights_folder)
        for net in ("depth_encoder", "pose_encoder", "depth_decoder", "pose_decoder"):
            module = getattr(self.model, net)
            saved = torch.load(folder / f"{net}.pth", map_location="cpu", weights_only=True)
            if net == "pose_encoder" and not any(k.startswith("resnet.") for k in saved):
                saved = {f"resnet.{k}": v for k, v in saved.items()}
            current = module.state_dict()
            missing = [k for k in current if k not in saved
                       and not k.endswith("num_batches_tracked")]
            if missing:
                raise KeyError(f"{folder / (net + '.pth')} lacks {missing[:5]}")
            module.load_state_dict({k: saved.get(k, v) for k, v in current.items()})
        self.is_trained = True
