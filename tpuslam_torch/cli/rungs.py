"""Run the BASELINE.json config ladder hermetically and print a table.

Counterpart of `tpuslam/cli/rungs.py`, with the same rungs, flags and table
plus `--device` (default cuda; `--device cpu` runs the kernels' plain
versions).  `--warp` maps each variant onto the port's `pallas_*` flags,
which `train/steps.py::loss_config` routes as the JAX package does
(`group_skip` and `dense` set `pallas_group_skip`, which the port accepts
and ignores).

The five rungs (BASELINE.json "configs"), executed on the synthetic world so
no datasets are needed:

  1. frozen inference (no adaptation)
  2. online expert adaptation (photometric fine-tune, no replay)
  3. dual-network expert+generalist with diversity replay
  4. full SLAM: + loop closures + pose-graph optimisation
  5. CoVIO async mode (decoupled inference/update) across 2 chained domains

Usage:
    python -m tpuslam_torch.cli.rungs [--frames 60] [--height 96] [--width 320]
                                      [--weights <checkpoint dir>] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from tpuslam_torch.config import Config
from tpuslam_torch.config.schema import (
    DatasetConfig,
    DepthPoseConfig,
    LoopClosureConfig,
    SlamConfig,
)
from tpuslam_torch.data import ChainedDataset, SyntheticDataset
from tpuslam_torch.eval.trajectory import compute_ate
from tpuslam_torch.slam import Slam


def _run(name, cfg, dataset, diagnostics=False, device="cuda"):
    """Run one rung to its end and print its table line; returns the Slam."""
    slam = Slam(cfg, dataset=dataset, device=device)
    t0 = time.perf_counter()
    slam.run(progress=False)
    wall = time.perf_counter() - t0
    pred = slam.pose_graph.get_all_poses()
    gt = slam.gt_pose_graph.get_all_poses()
    n = min(len(pred), len(gt))
    ate = compute_ate(pred[:n], gt[:n])
    rel_t = float(np.mean(slam.rel_trans_error)) if slam.rel_trans_error else float("nan")
    abs_rel = (
        float(np.mean([d["abs_rel"] for d in slam.depth_error]))
        if slam.depth_error
        else float("nan")
    )
    # steady-state fps: the first steps carry cuDNN autotuning and warm-up
    warm = slam.step_times[5:] or slam.step_times
    fps = len(warm) / max(sum(warm), 1e-9)
    print(
        f"{name:38s} ATE={ate:7.2f}m rel_trans={rel_t:.3f}m "
        f"abs_rel={abs_rel:.3f} loops={slam.pose_graph.num_loop_closures} "
        f"fps={fps:.2f} ({wall:.0f}s)"
    )
    if diagnostics:
        # LC-edge quality: a bad predicted relative pose makes the PGO pull
        # the trajectory off — THE candidate cause for rung 4 > rung 1 ATE
        # on untrained nets
        for d in slam.lc_edge_diagnostics:
            print(
                f"    lc_edge {d['step']:4d}->{d['lc_id']:4d} sim={d['sim']:.3f} "
                f"pred={d['pred_dist']:.2f}m gt={d.get('gt_dist', float('nan')):.2f}m "
                f"err={d.get('trans_err', float('nan')):.2f}m"
            )
        if slam.replay_composition:
            ids = [i for frame in slam.replay_composition for i in frame]
            uniq, counts = np.unique(ids, return_counts=True)
            top = sorted(zip(counts, uniq), reverse=True)[:8]
            print(
                f"    replay draws: {len(ids)} total, {len(uniq)} distinct; "
                "most drawn: "
                + ", ".join(f"id{int(i)}x{int(c)}" for c, i in top)
            )
    return slam


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run the BASELINE config ladder")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--weights", type=Path, default=None)
    ap.add_argument("--log", type=Path, default=Path("./log/rungs"))
    ap.add_argument(
        "--diagnostics", action="store_true",
        help="dump per-rung LC-edge quality + replay-batch composition",
    )
    ap.add_argument(
        "--rungs", type=str, default="1,2,3,4,5",
        help="comma-separated subset of rungs to run",
    )
    ap.add_argument(
        "--dtype", default=None, choices=["float32", "bfloat16"],
        help="conv compute dtype override (quality/speed A/B; params stay f32)",
    )
    ap.add_argument(
        "--depth-lr-scale", type=float, default=None,
        help="adapt_depth_lr_scale override (depth decoder adapts at "
             "learning_rate * scale; 1.0 reference-exact, 0.0 freezes the "
             "depth head online) — the VERDICT r3 #5 trade-off A/B knob",
    )
    ap.add_argument(
        "--warp", default=None,
        choices=["dense", "packed", "seg_skip", "group_skip", "tall",
                 "tall_proj"],
        help="warp variant override, mapped onto the pallas_* flags "
             "(quality/speed A/B): dense and group_skip (K1, the default), "
             "packed and seg_skip (K2 with bf16-truncated taps), tall (K4 "
             "with the K6 error maps and bf16 stored outputs), or tall_proj "
             "(the fused stack: K5, K6 and the K7/K8 backward)",
    )
    ap.add_argument(
        "--bf16-out", action="store_true",
        help="pallas_bf16_out on the default kernel (K1 stores bf16; "
             "quality A/B knob)",
    )
    ap.add_argument(
        "--seed", type=int, default=7,
        help="synthetic-world seed (vary for A/B spread — the round-5 "
             "multi-seed protocol; 7 = the historical tables)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)
    which = {int(r) for r in args.rungs.split(",")}

    def base_cfg(tag, batch_size=3, **slam_kwargs):
        cfg = Config()
        cfg.dataset = DatasetConfig(
            dataset="Synthetic", height=args.height, width=args.width,
            num_frames=args.frames, trajectory="loop",
        )
        warp_kwargs = {}
        if args.warp == "packed":
            warp_kwargs["pallas_packed"] = True
        elif args.warp == "seg_skip":
            warp_kwargs["pallas_seg_skip"] = True
        elif args.warp == "group_skip":
            warp_kwargs["pallas_group_skip"] = True
        elif args.warp == "dense":
            # group_skip defaults ON — "dense" must actually disable it
            warp_kwargs["pallas_group_skip"] = False
        elif args.warp == "tall":
            # the full round-4 fused pipeline (quality side of the bench
            # --tall --bf16-out --fused-loss A/B)
            warp_kwargs["pallas_tall"] = True
            warp_kwargs["pallas_bf16_out"] = True
            warp_kwargs["pallas_fused_loss"] = True
        elif args.warp == "tall_proj":
            # the FULL fused stack: in-kernel projection + composite
            # backward on top of tall+fused_loss (quality side of bench
            # --tall --bf16-out --fused-loss --fused-bwd --proj)
            warp_kwargs["pallas_tall"] = True
            warp_kwargs["pallas_bf16_out"] = True
            warp_kwargs["pallas_fused_loss"] = True
            warp_kwargs["pallas_fused_bwd"] = True
            warp_kwargs["pallas_proj"] = True
        if args.bf16_out:
            warp_kwargs["pallas_bf16_out"] = True
        cfg.depth_pose = DepthPoseConfig(
            batch_size=batch_size, scales=(0, 1, 2, 3), max_depth=80.0,
            log_path=args.log / tag, load_weights_folder=args.weights,
            **({"dtype": args.dtype} if args.dtype else {}),
            **(
                {"adapt_depth_lr_scale": args.depth_lr_scale}
                if args.depth_lr_scale is not None
                else {}
            ),
            **warp_kwargs,
        )
        defaults = dict(
            adaptation=True, adaptation_epochs=3, min_distance=0.0,
            do_loop_closures=False, keyframe_frequency=5, lc_distance_poses=20,
        )
        defaults.update(slam_kwargs)
        cfg.slam = SlamConfig(**defaults)
        cfg.loop_closure = LoopClosureConfig(
            detection_threshold=0.85, id_threshold=args.frames // 3, num_matches=1
        )
        cfg.replay_buffer.max_buffer_size = 20
        return cfg

    def world(seed=None, frames=None):
        return SyntheticDataset(
            num_frames=frames or args.frames, height=args.height,
            width=args.width, seed=args.seed if seed is None else seed,
            trajectory="loop", speed=0.8,
        )

    print(f"BASELINE config ladder — {args.frames} frames @ "
          f"{args.height}x{args.width}, weights={args.weights}")
    diag = args.diagnostics
    if 1 in which:
        _run("rung 1: frozen inference", base_cfg("r1", adaptation=False),
             world(), diag, args.device)
    if 2 in which:
        _run("rung 2: online adaptation (no replay)",
             base_cfg("r2", batch_size=1), world(), diag, args.device)
    if 3 in which:
        _run("rung 3: dual-network + replay",
             base_cfg("r3", use_expert=True, generalist_interval=5), world(), diag, args.device)
    if 4 in which:
        _run("rung 4: + loop closures + PGO",
             base_cfg("r4", do_loop_closures=True), world(), diag, args.device)

    def chained():
        return ChainedDataset(
            [world(frames=args.frames // 2),
             world(seed=args.seed + 4, frames=args.frames // 2)])

    if 5 in which:
        cfg5 = base_cfg("r5", async_adaptation=True)
        cfg5.dataset.num_frames = args.frames
        _run("rung 5: CoVIO async, 2-domain chain", cfg5, chained(), diag, args.device)
        # sync ablation of the SAME workload: the async decoupling's
        # throughput win is async-vs-sync at equal batch/replay config
        # (rung 2 is a different, cheaper workload: batch-1, no replay)
        cfg5s = base_cfg("r5_sync")
        cfg5s.dataset.num_frames = args.frames
        _run("rung 5 sync ablation (same config)", cfg5s, chained(), diag, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
