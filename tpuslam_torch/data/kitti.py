"""KITTI odometry loader (numpy host pipeline).

Reads the same on-disk layout as the reference loader
(reference datasets/kitti.py): `sequences/NN/image_2/*.png`,
`sequences/NN/oxts/{data/*.txt,timestamps.txt}`, `poses/NN.txt`, optional
`sequences/NN/gt_depth/image_02/*.png` (depth in cm).  Behavioural parity:

* normalised intrinsics constant (kitti.py:65-66) scaled to the working
  resolution,
* velocity -> relative-distance integration from oxts speed norms
  (kitti.py:319-331),
* min-distance frame filtering that accumulates skipped distance
  (kitti.py:217-229),
* GT relative/absolute poses for frame +1 (kitti.py:306-314),
* stereo view doubling for pretraining: `views=("left", "right")` doubles the
  dataset over image_2/image_3, all left frames first
  (datasets/utils.py:98-102,117-139),
* horizontal-flip augmentation mirrors the relative pose around the y-axis
  (negated [2,0]/[0,2] rotation terms and x translation).  The reference
  intends this too (kitti.py:306-314) but its adjustment writes to a key
  that is never populated, so it only ever runs in configurations that
  cannot occur (poses + augmentation together) — fixed here, documented in
  PARITY.md.
"""
from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Sequence, Union

import threading

import numpy as np

from tpuslam_torch.data.base import (
    KITTI_NORMALIZED_K,
    ImageCache,
    Sample,
    flip_sample_arrays,
    load_image,
    random_color_jitter,
    scale_intrinsics,
)

# KITTI raw-drive mapping for odometry sequences (00-10), used by the
# raw-data extraction CLI (reference kitti.py:361-440).
KITTI_RAW_SEQ_MAPPING = {
    0: ("2011_10_03", "2011_10_03_drive_0027_sync", 0, 4540),
    1: ("2011_10_03", "2011_10_03_drive_0042_sync", 0, 1100),
    2: ("2011_10_03", "2011_10_03_drive_0034_sync", 0, 4660),
    4: ("2011_09_30", "2011_09_30_drive_0016_sync", 0, 270),
    5: ("2011_09_30", "2011_09_30_drive_0018_sync", 0, 2760),
    6: ("2011_09_30", "2011_09_30_drive_0020_sync", 0, 1100),
    7: ("2011_09_30", "2011_09_30_drive_0027_sync", 0, 1100),
    8: ("2011_09_30", "2011_09_30_drive_0028_sync", 1100, 5170),
    9: ("2011_09_30", "2011_09_30_drive_0033_sync", 0, 1590),
    10: ("2011_09_30", "2011_09_30_drive_0034_sync", 0, 1200),
}


_FLIP_X = np.diag([-1.0, 1.0, 1.0, 1.0]).astype(np.float32)


def flip_relative_pose(rel_pose: np.ndarray) -> np.ndarray:
    """Relative pose of the horizontally-flipped scene: conjugation by the
    x-mirror, M T M — negates R[0,1]/R[1,0]/R[0,2]/R[2,0] and t_x.

    The reference intends the same y-axis mirror (kitti.py:306-314) but its
    adjustment is dead code (writes a never-set key) and partial (misses the
    [0,1]/[1,0] terms and t_x); the full conjugation is the exact transform
    of the mirrored camera trajectory."""
    return (_FLIP_X @ rel_pose @ _FLIP_X).astype(np.float32)


def _parse_timestamps(path: Path) -> np.ndarray:
    fmt = "%Y-%m-%d %H:%M:%S.%f"
    lines = path.read_text().splitlines()
    base = datetime.strptime(lines[0][:-3], fmt)
    return np.array(
        [(datetime.strptime(ln[:-3], fmt) - base).total_seconds() for ln in lines],
        dtype=np.float64,
    )


class KittiOdometry:
    """One or more KITTI odometry sequences as a frame-triplet stream."""

    def __init__(
        self,
        data_path: Union[str, Path],
        sequences: Union[int, Sequence[int]],
        height: int = 192,
        width: int = 640,
        with_poses: bool = True,
        with_depth: bool = False,
        with_mask: bool = False,
        min_distance: float = 0.0,
        do_augmentation: bool = False,
        seed: int = 42,
        views: Sequence[str] = ("left",),
    ):
        self.views = tuple(views)
        if not self.views or any(v not in ("left", "right") for v in self.views):
            raise ValueError(f"views must be 'left'/'right', got {views}")
        if with_depth and self.views != ("left",):
            # GT depth panels exist for the left camera only (reference
            # asserts views == ('left',) at kitti.py:291-296)
            raise ValueError("with_depth requires views=('left',)")
        self.data_path = Path(data_path)
        self.sequences = sorted(
            (sequences,) if isinstance(sequences, int) else tuple(sequences)
        )
        if any(s > 10 for s in self.sequences):
            raise ValueError("sequences above 10 have no ground-truth poses")
        if 3 in self.sequences:
            raise ValueError("sequence 3 has no IMU data")
        self.height = height
        self.width = width
        self.with_poses = with_poses
        self.with_depth = with_depth
        self.with_mask = with_mask
        self.do_augmentation = do_augmentation
        self._aug_rng = np.random.default_rng(seed)
        # concurrent __getitem__ (Slam.run prefetch_workers > 1) must not
        # corrupt the shared Generator — draws happen under this lock
        self._rng_lock = threading.Lock()
        self._images = ImageCache()  # sliding windows re-read 2 of 3 frames
        self.K = scale_intrinsics(KITTI_NORMALIZED_K, height, width)

        self.image_files: list = []
        self.depth_files: list = []
        self.mask_files: list = []
        self.global_poses_list: list = []
        self.relative_distances_list: list = []
        self._sequence_bounds: list = []  # (start, end) per sequence in concat order

        # view doubling: all left frames first, then all right frames
        # (reference datasets/utils.py:98-102,117-127)
        view_dirs = {"left": "image_2", "right": "image_3"}
        for view, seq in ((v, s) for v in self.views for s in self.sequences):
            img_dir = view_dirs[view]
            seq_dir = self.data_path / "sequences" / f"{seq:02d}"
            images = sorted((seq_dir / img_dir).glob("*.png"))
            if not images:
                raise FileNotFoundError(f"no images under {seq_dir / img_dir}")
            masks = (
                sorted((seq_dir / "segm_mask" / img_dir).glob("*.png"))
                if with_mask
                else []
            )
            ts = _parse_timestamps(seq_dir / "oxts" / "timestamps.txt")
            vel_files = sorted((seq_dir / "oxts" / "data").glob("*.txt"))
            speeds = np.array(
                [np.linalg.norm(np.loadtxt(f)[8:11]) for f in vel_files], np.float64
            )
            # distance between consecutive frames = mean speed * dt
            n = min(len(images), len(ts), len(speeds))
            images, ts, speeds = images[:n], ts[:n], speeds[:n]
            rel = np.zeros(n, np.float32)
            rel[1:] = ((speeds[:-1] + speeds[1:]) / 2 * np.diff(ts)).astype(np.float32)

            poses = None
            if with_poses:
                raw = np.loadtxt(self.data_path / "poses" / f"{seq:02d}.txt", dtype=np.float64)
                poses = np.tile(np.eye(4, dtype=np.float32), (len(raw), 1, 1))
                poses[:, :3, :4] = raw.reshape(-1, 3, 4).astype(np.float32)
                poses = poses[:n]

            depths: list = []
            if with_depth:
                depth_dir = seq_dir / "gt_depth" / "image_02"
                stems = {int(p.stem): p for p in depth_dir.glob("*.png")}
                keep = [i for i, img in enumerate(images) if int(img.stem) in stems]
                depths = [stems[int(images[i].stem)] for i in keep]
                images = [images[i] for i in keep]
                rel = rel[keep]
                ts = ts[keep]
                if poses is not None:
                    poses = poses[keep]

            if with_mask and len(masks) < len(images):
                raise FileNotFoundError("segm_mask does not cover all images")
            if min_distance > 0:
                # keep frames at least min_distance apart, accumulating the
                # skipped distance into the kept frame's relative distance
                keep = [0]
                acc = 0.0
                kept_rel = [0.0]
                for i in range(1, len(images)):
                    acc += abs(float(rel[i]))
                    if acc >= min_distance:
                        keep.append(i)
                        kept_rel.append(acc)
                        acc = 0.0
                images = [images[i] for i in keep]
                rel = np.asarray(kept_rel, np.float32)
                if poses is not None:
                    poses = poses[keep]
                if depths:
                    depths = [depths[i] for i in keep]
                if masks:
                    masks = [masks[i] for i in keep]

            start = len(self.image_files)
            self.image_files.extend(images)
            self.depth_files.extend(depths if depths else [None] * len(images))
            self.mask_files.extend(masks if masks else [None] * len(images))
            self.relative_distances_list.append(rel)
            if poses is not None:
                self.global_poses_list.append(poses)
            self._sequence_bounds.append((start, start + len(images)))

        self.relative_distances = np.concatenate(self.relative_distances_list)
        self.global_poses = (
            np.concatenate(self.global_poses_list) if self.global_poses_list else None
        )
        # valid center indices: one frame margin inside each sequence
        self._centers = []
        for start, end in self._sequence_bounds:
            self._centers.extend(range(start + 1, end - 1))

    def __len__(self) -> int:
        return len(self._centers)

    def _load_depth(self, path: Path) -> np.ndarray:
        from PIL import Image as PILImage

        depth = np.asarray(PILImage.open(path), dtype=np.float32)
        return depth / 100.0  # cm -> m (reference kitti.py:351)

    def _load_mask(self, path: Path) -> np.ndarray:
        from PIL import Image as PILImage

        m = PILImage.open(path).resize((self.width, self.height), PILImage.NEAREST)
        return np.round(np.asarray(m, np.float32) / max(np.asarray(m).max(), 1))

    def __getitem__(self, index: int) -> Sample:
        if not 0 <= index < len(self):
            raise IndexError(index)
        center = self._centers[index]
        frames = [
            self._images.load(self.image_files[center + off], self.height,
                              self.width)
            for off in (-1, 0, 1)
        ]
        rgb = np.stack(frames)
        rgb_aug = None
        mask = None
        if self.with_mask and self.mask_files[center] is not None:
            mask = self._load_mask(self.mask_files[center])
        do_flip = False
        if self.do_augmentation:
            with self._rng_lock:  # draws only; applying jitter is the cost
                jitter = random_color_jitter(self._aug_rng)
                flip = self._aug_rng.random() > 0.5
            rgb_aug = np.stack([jitter(f) for f in frames])
            if flip:
                rgb, rgb_aug, mask = flip_sample_arrays(rgb, rgb_aug, mask)
                do_flip = True

        rel_pose = abs_pose = None
        if self.global_poses is not None:
            rel_pose = (
                np.linalg.inv(self.global_poses[center]) @ self.global_poses[center + 1]
            ).astype(np.float32)
            abs_pose = self.global_poses[center + 1].astype(np.float32)
            if do_flip:
                rel_pose = flip_relative_pose(rel_pose)

        depth = None
        if self.with_depth and self.depth_files[center] is not None:
            depth = self._load_depth(self.depth_files[center])
            if do_flip:
                depth = depth[:, ::-1].copy()

        return Sample(
            index=index,
            rgb=rgb,
            rgb_aug=rgb_aug,
            K=self.K,
            rel_dist=np.array(
                [self.relative_distances[center], self.relative_distances[center + 1]],
                np.float32,
            ),
            rel_pose=rel_pose,
            abs_pose=abs_pose,
            depth=depth,
            mask=mask,
            filenames=tuple(self.image_files[center + off] for off in (-1, 0, 1)),
        )
