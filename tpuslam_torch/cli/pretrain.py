"""Pretraining entry point: the port's `main_pretrain.py`.

Counterpart of `tpuslam/cli/pretrain.py`, with the same flags plus
`--device` (default cuda; `--device cpu` runs on the CPU):

    python -m tpuslam_torch.cli.pretrain --config tpuslam_torch/config/defaults/pretrain_collapse_synthetic.yaml
    python -m tpuslam_torch.cli.pretrain --config <yaml> --epochs 1 --device cpu

Trains the depth and pose networks on the configured dataset (Cityscapes,
Kitti or Synthetic) and writes the `Pretrainer`'s checkpoint folders under
the config's `log_path` (`models/weights_NNN/`, `models/best.yaml`).

`--dp N` above 1 trains data-parallel on N cards (N processes started here,
one per card, over NCCL), or with `--device cpu` in N processes over gloo:

    python -m tpuslam_torch.cli.pretrain --config <yaml> --dp 2

The batch size must be a multiple of N.  Rank 0 alone validates, writes the
checkpoints and prints.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpuslam_torch import resolve_device
from tpuslam_torch.config import parse_config
from tpuslam_torch.parallel import local_init_method, make_process_group
from tpuslam_torch.train.pretrain import Pretrainer


def build_dataset(cfg, split: str):
    dc = cfg.dataset
    if dc.dataset == "Cityscapes":
        from tpuslam_torch.data.cityscapes import Cityscapes

        return Cityscapes(
            dc.dataset_path, split=split, height=dc.height, width=dc.width,
            do_augmentation=(split == "train"),
        )
    if dc.dataset == "Kitti":
        from tpuslam_torch.data import KittiOdometry

        train_set = cfg.depth_pose.train_set
        val_set = cfg.depth_pose.val_set
        if train_set == "all":
            val = (val_set,) if isinstance(val_set, int) else tuple(val_set)
            train_set = tuple(s for s in range(11) if s not in val and s != 3)
        seqs = train_set if split == "train" else val_set
        return KittiOdometry(
            dc.dataset_path, seqs, height=dc.height, width=dc.width,
            do_augmentation=(split == "train"),
        )
    if dc.dataset == "Synthetic":
        from tpuslam_torch.data import SyntheticDataset

        return SyntheticDataset(
            num_frames=dc.num_frames, height=dc.height, width=dc.width,
            trajectory=dc.trajectory, speed=dc.speed,
            do_augmentation=(split == "train"),
            seed=0 if split == "train" else 1,
        )
    raise ValueError(f"unsupported dataset {dc.dataset}")


def make_pretrainer(cfg, device="cuda", dp_devices=None) -> Pretrainer:
    """The `Pretrainer` of a parsed config (a resumed run builds the same
    one and calls `load`)."""
    pc = cfg.depth_pose
    return Pretrainer(
        height=cfg.dataset.height,
        width=cfg.dataset.width,
        scales=pc.scales,
        resnet_depth=pc.resnet_depth,
        resnet_pose=pc.resnet_pose,
        learning_rate=pc.learning_rate,
        scheduler_step_size=pc.scheduler_step_size,
        batch_size=pc.batch_size,
        min_depth=pc.min_depth,
        max_depth=pc.max_depth,
        disparity_smoothness=pc.disparity_smoothness,
        velocity_loss_scaling=pc.velocity_loss_scaling,
        mask_dynamic=pc.mask_dynamic,
        log_path=pc.log_path,
        dp_devices=dp_devices if dp_devices is not None else pc.dp_devices,
        encoder_weights=pc.encoder_weights,
        resnet_pretrained=pc.resnet_pretrained,
        scale_prior_epochs=pc.scale_prior_epochs,
        scale_prior_weight=pc.scale_prior_weight,
        dtype=pc.dtype,
        device=device,
    )


def _train(cfg, epochs, device, dp_devices) -> None:
    pc = cfg.depth_pose
    trainer = make_pretrainer(cfg, device, dp_devices)
    train_ds = build_dataset(cfg, "train")
    try:
        val_ds = build_dataset(cfg, "val")
    except Exception:
        val_ds = None
    if trainer.rank == 0:
        print(f"pretrain: {len(train_ds)} train samples, dp={trainer.dp_devices}")
    trainer.fit(
        train_ds,
        val_ds,
        num_epochs=epochs if epochs is not None else pc.num_epochs,
        save_frequency=pc.save_frequency,
        validate=val_ds is not None,
        depth_error=val_ds is not None,
        save_val_depth=(
            max(1, pc.save_val_depth_batches) * pc.batch_size
            if pc.save_val_depth
            else 0
        ),
    )


def _rank(rank: int, world: int, init_method: str, config: Path, epochs, device) -> None:
    """One rank of `--dp`: join the group, train, leave the group."""
    device = make_process_group(world, rank, device, init_method)
    try:
        _train(parse_config(config), epochs, device, world)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpuslam_torch pretraining")
    ap.add_argument("--config", required=True, type=Path)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--dp", type=int, default=None, help="data-parallel devices")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)

    cfg = parse_config(args.config)
    dp = args.dp if args.dp is not None else cfg.depth_pose.dp_devices
    if dp <= 1:
        _train(cfg, args.epochs, args.device, dp)
        return 0
    if resolve_device(args.device).type == "cuda" and dp > torch.cuda.device_count():
        raise ValueError(f"--dp {dp} needs {dp} cards, have {torch.cuda.device_count()}")
    mp.spawn(_rank, args=(dp, local_init_method(), args.config, args.epochs, args.device),
             nprocs=dp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
