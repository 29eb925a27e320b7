"""Oxford RobotCar loader + offline undistortion tooling.

Reads the same on-disk layout as the reference loader
(reference datasets/robotcar.py): `<seq>/stereo/center/*.png`
(undistorted/demosaiced frames named by microsecond timestamps), INS
velocities from `<seq>/gps/ins.csv`, intrinsics from
`camera_models/stereo_narrow_left.txt`, and RTK ground truth from
`rtk/<seq>/rtk.csv` with the reference's axis swaps (:146-168) and
SLERP/linear pose interpolation to image timestamps (:318-429).

The evaluation windows match the reference protocol (slam/slam.py:56-72):
sequence '2015-08-12-15-04-18', frames 750-4750 or 22100-26100, stride 2.

`undistort_robotcar` reproduces the offline preprocessing tool
(:494-548): GBRG Bayer demosaic (bilinear, numpy) + bilinear LUT
undistortion via the camera-model lookup table.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

import threading

import numpy as np
from scipy.interpolate import interp1d
from scipy.spatial.transform import Rotation, Slerp

from tpuslam_torch.data.base import (ImageCache, Sample, load_image,
                               random_color_jitter)

EVAL_WINDOWS = {1: (750, 4750), 2: (22100, 26100)}
DEFAULT_SEQUENCE = "2015-08-12-15-04-18"


def _read_csv_columns(path: Path, columns: Sequence[str]) -> np.ndarray:
    """Minimal CSV column reader (header row + float columns)."""
    with open(path) as f:
        header = f.readline().strip().split(",")
    idx = [header.index(c) for c in columns]
    data = np.genfromtxt(path, delimiter=",", skip_header=1, usecols=idx)
    return np.atleast_2d(data)


def _rtk_to_poses(utm: np.ndarray, rpy: np.ndarray) -> np.ndarray:
    """RTK northing/easting/down + roll/pitch/yaw -> camera-convention SE(3).

    Reference axis handling (robotcar.py:159-163): origin at the first pose,
    swap the y/z axes, negate the new z, zyx Euler rotations."""
    utm = utm - utm[0]
    utm[:, [1, 2]] = utm[:, [2, 1]]
    rpy = rpy.copy()
    rpy[:, [1, 2]] = rpy[:, [2, 1]]
    utm[:, 2] *= -1
    poses = np.tile(np.eye(4), (len(utm), 1, 1))
    poses[:, :3, :3] = Rotation.from_euler("zyx", rpy).as_matrix()
    poses[:, :3, 3] = utm
    return poses


def interpolate_poses(
    pose_timestamps: np.ndarray,
    poses: np.ndarray,
    requested_timestamps: np.ndarray,
) -> np.ndarray:
    """SLERP rotations + lerp translations at the requested timestamps."""
    t = np.asarray(pose_timestamps, np.float64)
    req = np.clip(np.asarray(requested_timestamps, np.float64), t[0], t[-1])
    rots = Rotation.from_matrix(poses[:, :3, :3])
    slerp = Slerp(t, rots)
    out = np.tile(np.eye(4), (len(req), 1, 1))
    out[:, :3, :3] = slerp(req).as_matrix()
    for k in range(3):
        out[:, k, 3] = np.interp(req, t, poses[:, k, 3])
    return out


class RobotCar:
    def __init__(
        self,
        data_path: Union[str, Path],
        sequence: str = DEFAULT_SEQUENCE,
        height: int = 192,
        width: int = 640,
        with_poses: bool = True,
        min_distance: float = 0.0,
        start_frame: int = 750,
        end_frame: int = -1,
        every_n_frame: int = 1,
        do_augmentation: bool = False,
        seed: int = 42,
        image_dir: str = "stereo/center",
    ):
        self.data_path = Path(data_path)
        self.sequence = sequence
        self.height = height
        self.width = width
        self.do_augmentation = do_augmentation
        self._aug_rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()  # concurrent __getitem__ safety
        self._images = ImageCache()  # sliding windows re-read 2 of 3 frames

        img_dir = self.data_path / sequence / image_dir
        files = sorted(img_dir.glob("*.png"))
        if not files:
            raise FileNotFoundError(f"no images under {img_dir}")
        end = end_frame if end_frame != -1 else len(files)
        self.image_files: List[Path] = files[start_frame:end:every_n_frame]
        self.timestamps = np.array([int(f.stem) for f in self.image_files], np.int64)

        self.K = self._load_intrinsics()

        # velocities: |v| interpolated at image timestamps (robotcar.py:111-124)
        ins = _read_csv_columns(
            self.data_path / sequence / "gps" / "ins.csv",
            ["timestamp", "velocity_north", "velocity_east", "velocity_down"],
        )
        speed = np.linalg.norm(ins[:, 1:], axis=1)
        self.velocity = interp1d(
            ins[:, 0], speed, bounds_error=False, fill_value=(speed[0], speed[-1])
        )(self.timestamps)
        dts = np.diff(self.timestamps) / 1e6  # microseconds -> s
        rel = np.zeros(len(self.timestamps), np.float32)
        rel[1:] = (self.velocity[1:] * dts).astype(np.float32)
        self.relative_distances = rel

        self.global_poses: Optional[np.ndarray] = None
        if with_poses:
            rtk = _read_csv_columns(
                self.data_path / "rtk" / sequence / "rtk.csv",
                ["timestamp", "northing", "easting", "down", "roll", "pitch", "yaw"],
            )
            poses = _rtk_to_poses(rtk[:, 1:4], rtk[:, 4:7])
            self.global_poses = interpolate_poses(rtk[:, 0], poses, self.timestamps)

        if min_distance > 0:
            keep = [0]
            kept_rel = [0.0]
            acc = 0.0
            for i in range(1, len(self.image_files)):
                acc += abs(float(self.relative_distances[i]))
                if acc >= min_distance:
                    keep.append(i)
                    kept_rel.append(acc)
                    acc = 0.0
            self.image_files = [self.image_files[i] for i in keep]
            self.timestamps = self.timestamps[keep]
            self.relative_distances = np.asarray(kept_rel, np.float32)
            if self.global_poses is not None:
                self.global_poses = self.global_poses[keep]

    def _load_intrinsics(self) -> np.ndarray:
        """Normalised intrinsics from the camera model, scaled to (H, W)."""
        from PIL import Image

        with Image.open(self.image_files[0]) as img:
            orig_w, orig_h = img.size
        model = self.data_path / "camera_models" / "stereo_narrow_left.txt"
        fx, fy, cx, cy = [float(x) for x in model.read_text().split()[:4]]
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = fx / orig_w * self.width
        K[0, 2] = cx / orig_w * self.width
        K[1, 1] = fy / orig_h * self.height
        K[1, 2] = cy / orig_h * self.height
        return K

    def __len__(self) -> int:
        return max(len(self.image_files) - 2, 0)

    def __getitem__(self, index: int) -> Sample:
        if not 0 <= index < len(self):
            raise IndexError(index)
        center = index + 1
        paths = [self.image_files[center + off] for off in (-1, 0, 1)]
        frames = [self._images.load(p, self.height, self.width)
                  for p in paths]
        rgb = np.stack(frames)
        rgb_aug = None
        if self.do_augmentation:
            with self._rng_lock:  # draws only; applying jitter is the cost
                jitter = random_color_jitter(self._aug_rng)
            rgb_aug = np.stack([jitter(f) for f in frames])
        rel_pose = abs_pose = None
        if self.global_poses is not None:
            rel_pose = (
                np.linalg.inv(self.global_poses[center]) @ self.global_poses[center + 1]
            ).astype(np.float32)
            abs_pose = self.global_poses[center + 1].astype(np.float32)
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
            filenames=tuple(paths),
        )


# ---------------------------------------------------------------------------
# Offline undistortion tooling (reference robotcar.py:494-678)


def demosaic_gbrg_bilinear(raw: np.ndarray) -> np.ndarray:
    """Bilinear demosaic of a GBRG Bayer mosaic -> (H, W, 3) float in [0, 1].

    The stereo cameras on RobotCar use the GBRG pattern; bilinear
    interpolation matches the reference's `demosaicing_CFA_Bayer_bilinear`.
    """
    raw = np.asarray(raw, np.float32)
    if raw.max() > 1.0:
        raw = raw / 255.0
    H, W = raw.shape
    yy, xx = np.mgrid[0:H, 0:W]
    # GBRG: (0,0)=G, (0,1)=B, (1,0)=R, (1,1)=G
    r_mask = (yy % 2 == 1) & (xx % 2 == 0)
    b_mask = (yy % 2 == 0) & (xx % 2 == 1)
    g_mask = ~(r_mask | b_mask)

    def interp(channel_mask):
        vals = np.where(channel_mask, raw, 0.0)
        weights = channel_mask.astype(np.float32)
        kernel = np.array([[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]])
        num = _conv2same(vals, kernel)
        den = _conv2same(weights, kernel)
        return num / np.maximum(den, 1e-8)

    rgb = np.stack([interp(r_mask), interp(g_mask), interp(b_mask)], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def _conv2same(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    from scipy.ndimage import convolve

    return convolve(img, kernel, mode="nearest")


class CameraModel:
    """RobotCar camera model: intrinsics, image->camera extrinsics and the
    undistortion lookup table (reference `CameraModel`,
    reference datasets/robotcar.py:553-678).

    The intrinsics file's first line is (fx, fy, cx, cy); the remaining lines
    are the 4x4 `G_camera_image` transform from the image frame to the camera
    frame (identity when absent).  The LUT maps each undistorted pixel to a
    sub-pixel location in the distorted image and is tied to the camera's
    native resolution — `undistort` enforces that pairing like the reference
    (:628-629) instead of silently reshaping.
    """

    def __init__(self, models_dir: Path, camera: str = "stereo_narrow_left"):
        models_dir = Path(models_dir)
        with open(models_dir / f"{camera}.txt", "r", encoding="utf-8") as f:
            vals = [float(x) for x in next(f).split()]
            self.focal_length = (vals[0], vals[1])
            self.principal_point = (vals[2], vals[3])
            rows = [[float(x) for x in line.split()] for line in f if line.strip()]
        # only a well-formed 4x4 block counts; anything else -> identity
        self.G_camera_image = (
            np.array(rows, np.float64)
            if len(rows) == 4 and all(len(r) == 4 for r in rows)
            else np.eye(4)
        )
        # legacy scalar aliases
        self.fx, self.fy = self.focal_length
        self.cx, self.cy = self.principal_point
        lut_file = models_dir / f"{camera}_distortion_lut.bin"
        self.lut = None
        if lut_file.exists():
            lut = np.fromfile(lut_file, np.double)
            self.lut = lut.reshape(2, lut.size // 2)  # rows: (u_map, v_map)

    @classmethod
    def from_images_dir(cls, models_dir: Path, images_dir: str) -> "CameraModel":
        """Resolve the model name from an image directory path like the
        reference's `__get_model_name` (:644-656): stereo left/right map to
        the wide models, centre to stereo_narrow_left; mono_* map directly."""
        import re

        m = re.search(r"(stereo|mono_(left|right|rear))", str(images_dir))
        if m is None:
            raise ValueError(f"cannot infer camera from {images_dir}")
        camera = m.group(0)
        if camera == "stereo":
            s = re.search(r"(left|center|centre|right)", str(images_dir))
            sensor = s.group(0) if s else "centre"
            camera = {
                "left": "stereo_wide_left",
                "right": "stereo_wide_right",
                "center": "stereo_narrow_left",
                "centre": "stereo_narrow_left",
            }[sensor]
        return cls(models_dir, camera)

    def scaled_intrinsics(self, height: int, width: int,
                          native_height: int = 960, native_width: int = 1280):
        """(fx, fy, cx, cy) rescaled from the camera's native resolution to a
        resized image — focal lengths and principal point scale with their
        axis (the pairing mistake the LUT check guards against at full res)."""
        sx, sy = width / native_width, height / native_height
        return (self.fx * sx, self.fy * sy, self.cx * sx, self.cy * sy)

    def project(self, xyz: np.ndarray, image_size) -> tuple:
        """Project camera-frame points into the image (reference :584-615):
        apply inv(G_camera_image), keep points in front, pinhole-project,
        keep in-bounds pixels.  Returns (uv (2, m), depths (m,))."""
        xyz = np.asarray(xyz, np.float64)
        if xyz.shape[0] == 3:
            xyz = np.vstack([xyz, np.ones((1, xyz.shape[1]))])
        xyzw = np.linalg.solve(self.G_camera_image, xyz)
        in_front = xyzw[2] >= 0
        xyzw = xyzw[:, in_front]
        uv = np.vstack([
            self.focal_length[0] * xyzw[0] / xyzw[2] + self.principal_point[0],
            self.focal_length[1] * xyzw[1] / xyzw[2] + self.principal_point[1],
        ])
        in_img = (
            (uv[0] >= 0.5) & (uv[0] <= image_size[1])
            & (uv[1] >= 0.5) & (uv[1] <= image_size[0])
        )
        return uv[:, in_img], np.ravel(xyzw[2, in_img])

    def undistort(self, image: np.ndarray) -> np.ndarray:
        """Bilinear LUT undistortion (reference CameraModel.undistort,
        :617-642).  The LUT is resolution-specific: a mismatched image size
        is an error, not a silent reshape."""
        if self.lut is None:
            return image
        from scipy.ndimage import map_coordinates

        H, W = image.shape[:2]
        if H * W != self.lut.shape[1]:
            raise ValueError(
                f"Incorrect image size for camera model: image {H}x{W} vs "
                f"LUT of {self.lut.shape[1]} pixels — undistort at the native "
                "resolution, then resize"
            )
        u = self.lut[0].reshape(H, W)
        v = self.lut[1].reshape(H, W)
        # out-of-range samples fall to 0 like the reference's map_coordinates
        # defaults (order=1, mode='constant')
        channels = [
            map_coordinates(image[..., c], [v, u], order=1)
            for c in range(image.shape[-1])
        ]
        return np.stack(channels, axis=-1)


def _undistort_one(args) -> None:
    # module-level so it pickles for multiprocessing workers
    from PIL import Image

    f, out_dir, model = args
    raw = np.asarray(Image.open(f))
    rgb = demosaic_gbrg_bilinear(raw)
    rgb = model.undistort(rgb)
    Image.fromarray((rgb * 255).astype(np.uint8)).save(Path(out_dir) / f.name)


def undistort_robotcar(
    data_path: Path,
    sequence: str,
    out_dir_name: str = "stereo/center",
    raw_dir_name: str = "stereo/centre",
    max_images: Optional[int] = None,
    num_workers: Optional[int] = None,
) -> int:
    """Offline preprocessing: Bayer raw -> demosaiced, undistorted PNGs.

    Parallelised over a process pool like the reference
    (datasets/robotcar.py:505-510); `num_workers=None` uses all cores,
    0/1 runs inline (useful for tests)."""
    import os

    data_path = Path(data_path)
    model = CameraModel(data_path / "camera_models")
    raw_dir = data_path / sequence / raw_dir_name
    out_dir = data_path / sequence / out_dir_name
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(raw_dir.glob("*.png"))
    if max_images is not None:
        files = files[:max_images]
    jobs = [(f, out_dir, model) for f in files]
    workers = os.cpu_count() if num_workers is None else num_workers
    if workers and workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.Pool(min(workers, len(jobs))) as pool:
            pool.map(_undistort_one, jobs)
    else:
        for job in jobs:
            _undistort_one(job)
    return len(files)
