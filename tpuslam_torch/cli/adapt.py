"""Online adaptation entry point: the port's `main_adapt.py`.

Counterpart of `tpuslam/cli/adapt.py`, with the same flags and output plus
`--device` (default cuda; `--device cpu` runs the kernels' plain versions).

    python -m tpuslam_torch.cli.adapt --config tpuslam_torch/config/defaults/adapt_synthetic.yaml
    python -m tpuslam_torch.cli.adapt --config <yaml> --max-steps 100 --device cpu

Runs the SLAM loop over the configured sequence, saves the metrics and the
model, and appends the final trajectory error report to
`<log_path>/log.txt`.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tpuslam_torch.config import parse_config
from tpuslam_torch.slam import Slam


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpuslam_torch online adaptation")
    ap.add_argument("--config", required=True, type=Path)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--no-progress", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="override slam.pipeline_depth: retire each frame's host "
                         "bookkeeping N frames after its dispatch (0 = every frame)")
    ap.add_argument("--prefetch-workers", type=int, default=1,
                    help="host threads that prepare the frames ahead")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)

    np.random.seed(args.seed)
    config = parse_config(args.config)
    if args.pipeline_depth is not None:
        config.slam.pipeline_depth = args.pipeline_depth
    slam = Slam(config, device=args.device)
    print(f"tpuslam adapt: {len(slam)} frames, log -> {slam.log_path}")
    slam.run(max_steps=args.max_steps, progress=not args.no_progress,
             prefetch_workers=args.prefetch_workers)

    slam.save_metrics()
    slam.save_model()
    try:
        from tpuslam_torch.viz.plots import plot_metrics, plot_trajectory

        plot_trajectory(slam, slam.log_path / "trajectory.png")
        plot_metrics(slam, slam.log_path / "metrics.png")
    except Exception as e:  # plotting must never kill a finished run
        print(f"plotting skipped: {e}")

    report = slam.final_report()
    print(report)
    with open(slam.log_path / "log.txt", "a") as f:
        f.write(f"config: {args.config}\n{report}\n")
    if slam.step_times:
        fps = 1.0 / float(np.mean(slam.step_times[3:] or slam.step_times))
        warm = slam.step_times[5:] or slam.step_times
        steady = 1.0 / float(np.mean(warm))
        print(f"throughput: {fps:.1f} frames/sec (incl. host); "
              f"steady-state {steady:.1f} fps over the last {len(warm)} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
