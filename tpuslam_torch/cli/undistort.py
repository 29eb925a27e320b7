"""Offline RobotCar preprocessing: Bayer demosaic + LUT undistortion.

Counterpart of the reference's `datasets/robotcar.py __main__` tool
(robotcar.py:494-548, 683-689).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from tpuslam_torch.data.robotcar import undistort_robotcar


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="undistort RobotCar raw images")
    ap.add_argument("--data", required=True, type=Path, help="RobotCar dataset root")
    ap.add_argument("--sequence", required=True)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None,
                    help="process-pool size (default: all cores)")
    args = ap.parse_args(argv)
    n = undistort_robotcar(
        args.data, args.sequence,
        max_images=args.max_images, num_workers=args.workers,
    )
    print(f"undistorted {n} images")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
