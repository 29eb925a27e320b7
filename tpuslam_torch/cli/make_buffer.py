"""Prime a replay buffer from a dataset (`make_cityscapes_buffer.py` parity).

Counterpart of `tpuslam/cli/make_buffer.py`, with the same flags plus
`--device` (default cuda; `--device cpu` runs on the CPU):

    python -m tpuslam_torch.cli.make_buffer --config <yaml> [--split train] [--out DIR]
        [--max-samples N] [--device cpu]

Streams every sample of the configured dataset through the replay buffer's
diversity-gated `add`, each frame embedded by the depth encoder's pooled,
L2-normalised stage-4 feature (`predict_depth_step`), and saves the buffer
state for later SLAM runs.  The networks come from the config's
`load_weights_folder` (a checkpoint of either package) when it exists, else
from random weights; the port draws its random weights from another
generator than the JAX package's `PRNGKey(0)`, so the two packages give the
same buffer only from the same checkpoint.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tpuslam_torch import resolve_device
from tpuslam_torch.checkpoint.io import load_checkpoint
from tpuslam_torch.cli.pretrain import build_dataset
from tpuslam_torch.config import parse_config
from tpuslam_torch.memory.replay_buffer import ReplayBuffer
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.train.steps import predict_depth_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="prime a replay buffer")
    ap.add_argument("--config", required=True, type=Path)
    ap.add_argument("--split", default="train")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = parse_config(args.config)
    dataset = build_dataset(cfg, args.split)
    out = args.out or cfg.replay_buffer.load_path or Path("./replay_buffer")
    rb = cfg.replay_buffer
    buffer = ReplayBuffer(
        storage_dir=out,
        height=cfg.dataset.height,
        width=cfg.dataset.width,
        max_buffer_size=rb.max_buffer_size,
        maximize_diversity=rb.maximize_diversity,
        similarity_threshold=rb.similarity_threshold,
        similarity_sampling=rb.similarity_sampling,
    )

    model = init_depth_pose(0, device=device)
    lw = cfg.depth_pose.load_weights_folder
    if lw is not None and Path(lw).exists():
        load_checkpoint(lw, model)

    n = len(dataset) if args.max_samples is None else min(args.max_samples, len(dataset))
    for i in range(n):
        sample = dataset[i]
        image = torch.from_numpy(np.ascontiguousarray(sample.rgb[1][None])).to(device)
        _, emb = predict_depth_step(model, image)
        buffer.add(sample, emb[0].cpu().numpy(), verbose=(i % 50 == 0))
    path = buffer.save_state()
    print(f"buffer: {len(buffer)} samples -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
