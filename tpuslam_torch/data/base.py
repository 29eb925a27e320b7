"""Host-side data pipeline primitives (numpy; no torch).

Replaces the reference's torch Dataset/DataLoader stack
(reference datasets/utils.py) with a lean numpy pipeline: datasets
yield `Sample` records (full-resolution frame triplets + calibration); the
multi-scale pyramid is built on-device inside the fused step, so the host
only decodes, resizes to the working resolution, and color-jitters.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

try:  # PIL for image decode + LANCZOS resize (reference parity)
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

KITTI_NORMALIZED_K = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    dtype=np.float32,
)


@dataclasses.dataclass
class Sample:
    """One frame triplet with calibration and supervision signals.

    Frames are ordered (-1, 0, 1) along axis 0; images are (3, H, W, 3)
    float32 in [0, 1] (NHWC per frame).
    """

    index: int
    rgb: np.ndarray  # (3, H, W, 3)
    K: np.ndarray  # (4, 4) pixel-unit intrinsics at (H, W)
    rel_dist: np.ndarray  # (2,) relative distances for frames (0, 1)
    rgb_aug: Optional[np.ndarray] = None  # color-jittered copy (3, H, W, 3)
    rel_pose: Optional[np.ndarray] = None  # (4, 4) GT pose of frame +1 wrt frame 0
    abs_pose: Optional[np.ndarray] = None  # (4, 4) GT global pose of frame +1
    depth: Optional[np.ndarray] = None  # (H0, W0) GT depth of frame 0, meters
    mask: Optional[np.ndarray] = None  # (H, W) dynamic-object mask, 1 = dynamic
    filenames: Optional[Sequence[Path]] = None  # source paths of the 3 frames

    @property
    def aug(self) -> np.ndarray:
        return self.rgb_aug if self.rgb_aug is not None else self.rgb


def load_image(path: Path, height: int, width: int) -> np.ndarray:
    """Decode + LANCZOS-resize to the working resolution -> (H, W, 3) f32."""
    if Image is None:  # pragma: no cover
        raise RuntimeError("PIL is required for image decoding")
    img = Image.open(path).convert("RGB")
    if img.size != (width, height):
        img = img.resize((width, height), Image.LANCZOS)
    return np.asarray(img, dtype=np.float32) / 255.0


class ImageCache:
    """Small thread-safe LRU over decoded frames at the working resolution.

    The SLAM loop reads sliding (-1, 0, +1) windows, so consecutive
    `dataset[i]` calls would decode two of their three source images again;
    with the cache about one decode and LANCZOS resize is left per frame.
    Returned arrays are shared: callers treat them as read-only (every
    consumer stacks or copies)."""

    def __init__(self, capacity: int = 8):
        self._cap = capacity
        self._lock = threading.Lock()
        self._store = OrderedDict()

    def load(self, path: Path, height: int, width: int) -> np.ndarray:
        key = (str(path), height, width)
        with self._lock:
            img = self._store.get(key)
            if img is not None:
                self._store.move_to_end(key)
                return img
        img = load_image(path, height, width)
        with self._lock:
            self._store[key] = img
            while len(self._store) > self._cap:
                self._store.popitem(last=False)
        return img


def scale_intrinsics(K_normalized: np.ndarray, height: int, width: int) -> np.ndarray:
    """Normalised intrinsics -> pixel units (reference datasets/utils.py:104-110)."""
    K = np.asarray(K_normalized, np.float32).copy()
    K[0, :] *= width
    K[1, :] *= height
    return K


def flip_sample_arrays(rgb, rgb_aug=None, mask=None):
    """Horizontal flip of a frame triplet (+aug, +mask), the reference's
    do_flip augmentation (datasets/utils.py:148-151, kitti.py:252-253).
    Monodepth2 assumes a centred principal point, so intrinsics are kept."""
    rgb = rgb[..., ::-1, :].copy()
    if rgb_aug is not None:
        rgb_aug = rgb_aug[..., ::-1, :].copy()
    if mask is not None:
        mask = mask[..., ::-1].copy()
    return rgb, rgb_aug, mask


# ---------------------------------------------------------------------------
# Color jitter (torchvision-equivalent, vectorised numpy)

_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def _blend(a: np.ndarray, b: np.ndarray, f: float) -> np.ndarray:
    return np.clip(f * a + (1.0 - f) * b, 0.0, 1.0)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = (img @ _GRAY).mean(dtype=np.float32)
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img @ _GRAY)[..., None]
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Shift hue by `factor` (in turns, [-0.5, 0.5]) via HSV round-trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(axis=-1)
    minc = img.min(axis=-1)
    v = maxc
    delta = maxc - minc
    safe = np.where(delta == 0, 1.0, delta)
    s = np.where(maxc == 0, 0.0, delta / np.where(maxc == 0, 1.0, maxc))
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta == 0, 0.0, h) / 6.0 % 1.0
    h = (h + factor) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([v, t, p], -1),
            np.stack([q, v, p], -1),
            np.stack([p, v, t], -1),
            np.stack([p, q, v], -1),
            np.stack([t, p, v], -1),
            np.stack([v, p, q], -1),
        ],
    )
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def random_color_jitter(
    rng: np.random.Generator,
    brightness=(0.8, 1.2),
    contrast=(0.8, 1.2),
    saturation=(0.8, 1.2),
    hue=(-0.1, 0.1),
) -> Callable[[np.ndarray], np.ndarray]:
    """Sample one jitter (shared across the triplet, like the reference's
    per-item transform, datasets/utils.py:236-259) applied in random order."""
    ops = [
        lambda x, f=rng.uniform(*brightness): adjust_brightness(x, f),
        lambda x, f=rng.uniform(*contrast): adjust_contrast(x, f),
        lambda x, f=rng.uniform(*saturation): adjust_saturation(x, f),
        lambda x, f=rng.uniform(*hue): adjust_hue(x, f),
    ]
    order = rng.permutation(len(ops))

    def apply(img: np.ndarray) -> np.ndarray:
        for i in order:
            img = ops[i](img)
        return img

    return apply


# ---------------------------------------------------------------------------
# Prefetching iterator: overlap host decode with device compute.


class Prefetcher:
    """Background-thread prefetch (double buffering) over any iterator.

    One thread that stays `depth` items ahead of the consumer; the items are
    host (numpy) work only, so the thread never touches the device."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._iterator = iterator
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._iterator:
                self._queue.put(item)
        finally:
            self._queue.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            raise StopIteration
        return item
