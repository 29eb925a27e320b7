"""Cityscapes sequence loader for pretraining.

Reads the same on-disk layout as the reference loader
(reference datasets/cityscapes.py): `leftImg8bit_sequence/<split>/
<city>/<city>_<seq>_<frame>_leftImg8bit.png`, per-recording intrinsics from
`camera/<split>/<city>/*_camera.json`, vehicle speed/timestamps from
`vehicle_sequence/<split>/<city>/*_vehicle.json`, and optional precomputed
disparity for GT depth (baseline * fx / disparity, reference :228-246).

Sequence boundaries come from the filename pattern: consecutive frame numbers
within the same (city, seq) belong to one recording (reference :100-123).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import threading

import numpy as np

from tpuslam_torch.data.base import (ImageCache, Sample, flip_sample_arrays,
                               load_image, random_color_jitter)


def _parse_name(path: Path) -> Tuple[str, str, int]:
    """'<city>_<seq>_<frame>_leftImg8bit.png' -> (city, seq, frame)."""
    parts = path.stem.split("_")
    return parts[0], parts[1], int(parts[2])


class Cityscapes:
    def __init__(
        self,
        data_path: Union[str, Path],
        split: str = "train",
        height: int = 192,
        width: int = 640,
        do_augmentation: bool = False,
        with_depth: bool = False,
        with_mask: bool = False,
        seed: int = 42,
    ):
        self.data_path = Path(data_path)
        self.split = split
        self.height = height
        self.width = width
        self.do_augmentation = do_augmentation
        self.with_depth = with_depth
        self.with_mask = with_mask
        self._aug_rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()  # concurrent __getitem__ safety
        self._images = ImageCache()  # sliding windows re-read 2 of 3 frames

        seq_dir = self.data_path / "leftImg8bit_sequence" / split
        if not seq_dir.exists():
            raise FileNotFoundError(seq_dir)
        files = sorted(seq_dir.glob("*/*_leftImg8bit.png"))
        if not files:
            raise FileNotFoundError(f"no images under {seq_dir}")

        # group into continuous recordings
        self.image_files: List[Path] = []
        self._centers: List[int] = []
        prev_key: Optional[Tuple[str, str]] = None
        prev_frame = None
        run_start = 0
        for f in files:
            city, seq, frame = _parse_name(f)
            key = (city, seq)
            if key != prev_key or (prev_frame is not None and frame != prev_frame + 1):
                run_start = len(self.image_files)
            self.image_files.append(f)
            if len(self.image_files) - run_start >= 3:
                self._centers.append(len(self.image_files) - 2)
            prev_key, prev_frame = key, frame

        self._K_cache: Dict[Tuple[str, str], np.ndarray] = {}
        self._vehicle_cache: Dict[Path, Optional[dict]] = {}

    def __len__(self) -> int:
        return len(self._centers)

    def _camera_json(self, city: str, stem: str) -> Optional[dict]:
        cam = (
            self.data_path
            / "camera"
            / self.split
            / city
            / f"{stem.replace('_leftImg8bit', '')}_camera.json"
        )
        if cam.exists():
            with open(cam) as f:
                return json.load(f)
        return None

    def _intrinsics(self, path: Path) -> np.ndarray:
        city, seq, _ = _parse_name(path)
        key = (city, seq)
        if key not in self._K_cache:
            data = self._camera_json(city, path.stem)
            if data is not None:
                intr = data["intrinsic"]
                # original resolution 2048x1024; normalise then scale
                K = np.eye(4, dtype=np.float32)
                K[0, 0] = intr["fx"] / 2048 * self.width
                K[1, 1] = intr["fy"] / 1024 * self.height
                K[0, 2] = intr["u0"] / 2048 * self.width
                K[1, 2] = intr["v0"] / 1024 * self.height
                self._K_cache[key] = K
            else:  # fall back to the KITTI-style normalised default
                K = np.eye(4, dtype=np.float32)
                K[0, 0] = 0.58 * self.width
                K[1, 1] = 1.92 * self.height
                K[0, 2] = 0.5 * self.width
                K[1, 2] = 0.5 * self.height
                self._K_cache[key] = K
        return self._K_cache[key]

    def _vehicle(self, path: Path) -> Optional[dict]:
        veh = (
            self.data_path
            / "vehicle_sequence"
            / self.split
            / _parse_name(path)[0]
            / f"{path.stem.replace('_leftImg8bit', '')}_vehicle.json"
        )
        if veh not in self._vehicle_cache:
            if veh.exists():
                with open(veh) as f:
                    self._vehicle_cache[veh] = json.load(f)
            else:
                self._vehicle_cache[veh] = None
        return self._vehicle_cache[veh]

    def _relative_distance(self, a: Path, b: Path) -> float:
        """Mean speed * dt between two frames (reference :213-226); falls
        back to speed/17Hz when timestamps are missing."""
        va, vb = self._vehicle(a), self._vehicle(b)
        if va is None or vb is None:
            return 0.0
        speed = (va.get("speed", 0.0) + vb.get("speed", 0.0)) / 2.0
        ta, tb = va.get("timestamp"), vb.get("timestamp")
        dt = (tb - ta) / 1e9 if (ta is not None and tb is not None) else 1.0 / 17.0
        return float(speed * dt)

    def __getitem__(self, index: int) -> Sample:
        if not 0 <= index < len(self):
            raise IndexError(index)
        center = self._centers[index]
        paths = [self.image_files[center + off] for off in (-1, 0, 1)]
        frames = [self._images.load(p, self.height, self.width)
                  for p in paths]
        rgb = np.stack(frames)
        rgb_aug = None
        mask = self._load_mask(paths[1]) if self.with_mask else None
        if self.do_augmentation:
            with self._rng_lock:  # draws only; applying jitter is the cost
                jitter = random_color_jitter(self._aug_rng)
                flip = self._aug_rng.random() > 0.5
            rgb_aug = np.stack([jitter(f) for f in frames])
            if flip:
                rgb, rgb_aug, mask = flip_sample_arrays(rgb, rgb_aug, mask)
        rel = np.array(
            [
                self._relative_distance(paths[0], paths[1]),
                self._relative_distance(paths[1], paths[2]),
            ],
            np.float32,
        )
        return Sample(
            index=index,
            rgb=rgb,
            rgb_aug=rgb_aug,
            K=self._intrinsics(paths[1]),
            rel_dist=rel,
            mask=mask,
            filenames=tuple(paths),
        )

    def _load_mask(self, image_path: Path):
        """Dynamic-object mask for frame 0 from `segm_mask/<split>/<city>/`
        (reference cityscapes dynamic-object masks, :159-168); zeros when the
        file is absent so mask_dynamic runs degrade gracefully."""
        from PIL import Image as PILImage

        city = _parse_name(image_path)[0]
        mask_path = (
            self.data_path / "segm_mask" / self.split / city / image_path.name
        )
        if not mask_path.exists():
            return np.zeros((self.height, self.width), np.float32)
        m = PILImage.open(mask_path).resize(
            (self.width, self.height), PILImage.NEAREST
        )
        arr = np.asarray(m, np.float32)
        return np.round(arr / max(arr.max(), 1))
