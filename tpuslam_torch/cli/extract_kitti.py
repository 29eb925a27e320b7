"""Copy KITTI *raw* drive data into the odometry layout.

Counterpart of the reference's `datasets/kitti.py __main__` raw-data
extraction (kitti.py:361-454): copies oxts velocity/timestamp files from the
raw drives into `sequences/NN/oxts/` using `KITTI_RAW_SEQ_MAPPING` so
velocity supervision is available for the odometry sequences.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from tpuslam_torch.data.kitti import KITTI_RAW_SEQ_MAPPING


def extract_raw_data(raw_path: Path, odometry_path: Path, sequences=None) -> None:
    sequences = sequences or sorted(KITTI_RAW_SEQ_MAPPING)
    for seq in sequences:
        if seq not in KITTI_RAW_SEQ_MAPPING:
            raise ValueError(f"sequence {seq} has no raw-drive mapping")
        date, drive, start, end = KITTI_RAW_SEQ_MAPPING[seq]
        src_oxts = raw_path / date / drive / "oxts"
        dst_oxts = odometry_path / "sequences" / f"{seq:02d}" / "oxts"
        (dst_oxts / "data").mkdir(parents=True, exist_ok=True)

        data_files = sorted((src_oxts / "data").glob("*.txt"))[start : end + 1]
        for i, f in enumerate(data_files):
            shutil.copy(f, dst_oxts / "data" / f"{i:010d}.txt")

        ts_lines = (src_oxts / "timestamps.txt").read_text().splitlines()
        (dst_oxts / "timestamps.txt").write_text(
            "\n".join(ts_lines[start : end + 1]) + "\n"
        )
        print(f"seq {seq:02d}: {len(data_files)} oxts frames from {drive}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="extract KITTI raw oxts into odometry layout")
    ap.add_argument("--raw", required=True, type=Path, help="KITTI raw data root")
    ap.add_argument("--odometry", required=True, type=Path, help="odometry dataset root")
    ap.add_argument("--sequences", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    extract_raw_data(args.raw, args.odometry, args.sequences)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
