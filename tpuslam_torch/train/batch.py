"""Device batch layout for the fused steps.

Counterpart of `tpuslam/train/batch.py`: one frame triplet per sample, NHWC,
frame axis ordered (-1, 0, 1); `rel_dist[:, 0]` is the -1 -> 0 distance and
`rel_dist[:, 1]` the 0 -> 1 distance.  `weights` are the per-sample loss
weights and double as padding: a short replay batch is padded with
zero-weight samples so every frame has the same shapes.  `mask` is the
dynamic-object mask of frame 0, read only under `LossConfig.mask_dynamic`;
None stands for the JAX package's all-zero mask.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from tpuslam_torch import tracing

FRAME_AXIS = (-1, 0, 1)

_to_uint8_lib: Optional[ctypes.CDLL] = None


def _to_uint8_library() -> ctypes.CDLL:
    """The uint8 rounding's library, built by the host compiler at first use."""
    global _to_uint8_lib
    if _to_uint8_lib is None:
        from tpuslam_torch.ops import build

        lib = build.load_library("to_uint8")
        lib.tpuslam_to_uint8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.tpuslam_to_uint8.restype = None
        _to_uint8_lib = lib
    return _to_uint8_lib


def to_uint8(img: np.ndarray) -> np.ndarray:
    """`np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)`, bytes for
    bytes: float32 images in one compiled pass (`csrc/to_uint8.cpp`, counted
    by the tracer as `to_uint8_values`), other dtypes by the expression
    itself, whose product rounds in their own precision."""
    if img.dtype != np.float32:
        return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
    src = np.ascontiguousarray(img)
    out = np.empty(src.shape, np.uint8)
    _to_uint8_library().tpuslam_to_uint8(src.ctypes.data, out.ctypes.data, src.size)
    if tracing.on:
        tracing.count("to_uint8_values", src.size)
    return out


@dataclasses.dataclass
class FrameBatch:
    """Images may be uint8 (a 4x smaller host-to-device copy, lossless for
    8-bit camera data); `frame()` converts to float32 in [0, 1] on the device."""

    rgb: torch.Tensor  # (B, 3, H, W, 3) uint8 or f32 [0, 1], frames (-1, 0, 1)
    rgb_aug: torch.Tensor  # (B, 3, H, W, 3) color-jittered network input
    K: torch.Tensor  # (B, 4, 4) pixel-unit intrinsics at full resolution
    inv_K: torch.Tensor  # (B, 4, 4)
    rel_dist: torch.Tensor  # (B, 2)
    weights: torch.Tensor  # (B,) per-sample loss weights (sum to 1)
    mask: Optional[torch.Tensor] = None  # (B, H, W) f32, 1 = dynamic object

    @property
    def batch_size(self) -> int:
        return self.rgb.shape[0]

    @property
    def height(self) -> int:
        return self.rgb.shape[2]

    @property
    def width(self) -> int:
        return self.rgb.shape[3]

    def frame(self, frame_id: int, aug: bool = False) -> torch.Tensor:
        img = (self.rgb_aug if aug else self.rgb)[:, FRAME_AXIS.index(frame_id)]
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        return img


@tracing.traced("data.frame_batch")
def make_frame_batch(
    rgb: np.ndarray,
    K: np.ndarray,
    rel_dist: np.ndarray,
    rgb_aug: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    device="cuda",
    mask: Optional[np.ndarray] = None,
) -> FrameBatch:
    """Host arrays -> a FrameBatch on `device` (aug defaults to rgb, weights
    to uniform, the mask to None).  Images ship as uint8, float inputs
    rounded to the nearest 1/255 level by `to_uint8` (span
    `data.to_uint8`).  The bytes handed to `device` add to the tracer's
    counter `h2d_bytes` (on the CPU too, where nothing is copied)."""
    from tpuslam_torch import resolve_device

    device = resolve_device(device)
    rgb = np.asarray(rgb)
    B = rgb.shape[0]
    if weights is None:
        weights = np.full((B,), 1.0 / B, np.float32)
    K = np.asarray(K, np.float32)
    if K.ndim == 2:
        K = np.broadcast_to(K, (B, 4, 4))
    inv_K = np.linalg.inv(K)

    def ship(x: np.ndarray) -> torch.Tensor:
        if tracing.on:
            tracing.count("h2d_bytes", x.nbytes)
        return torch.from_numpy(x).to(device)

    def prep(img):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            with tracing.span("data.to_uint8"):
                img = to_uint8(img)
        return ship(np.ascontiguousarray(img))

    prgb = prep(rgb)
    paug = prgb if rgb_aug is None else prep(rgb_aug)

    def put(x):
        return ship(np.array(x, np.float32))

    return FrameBatch(rgb=prgb, rgb_aug=paug, K=put(K), inv_K=put(inv_K),
                      rel_dist=put(rel_dist), weights=put(weights),
                      mask=None if mask is None else put(mask))


def pad_batch(batch: FrameBatch, target_size: int) -> FrameBatch:
    """Pad to `target_size` samples with zero-weight copies of sample 0."""
    B = batch.batch_size
    if B == target_size:
        return batch
    if B > target_size:
        raise ValueError(f"batch size {B} exceeds target {target_size}")
    pad = target_size - B

    def pad_arr(x):
        return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])

    return FrameBatch(
        rgb=pad_arr(batch.rgb),
        rgb_aug=pad_arr(batch.rgb_aug),
        K=pad_arr(batch.K),
        inv_K=pad_arr(batch.inv_K),
        rel_dist=pad_arr(batch.rel_dist),
        weights=torch.cat([batch.weights, batch.weights.new_zeros(pad)]),
        mask=None if batch.mask is None else pad_arr(batch.mask),
    )


def concat_batches(a: FrameBatch, b: FrameBatch) -> FrameBatch:
    """Concatenate along the sample axis (online ++ replay).

    Each side's weights sum to 1 and are scaled by its share of the combined
    batch, so uniform weights within each side give uniform 1/B overall."""
    Ba, Bb = a.batch_size, b.batch_size
    w = torch.cat([a.weights * (Ba / (Ba + Bb)), b.weights * (Bb / (Ba + Bb))])
    return FrameBatch(
        rgb=torch.cat([a.rgb, b.rgb]),
        rgb_aug=torch.cat([a.rgb_aug, b.rgb_aug]),
        K=torch.cat([a.K, b.K]),
        inv_K=torch.cat([a.inv_K, b.inv_K]),
        rel_dist=torch.cat([a.rel_dist, b.rel_dist]),
        weights=w,
        mask=_concat_masks(a, b),
    )


def _concat_masks(a: FrameBatch, b: FrameBatch) -> Optional[torch.Tensor]:
    """The masks of `concat_batches`; a side without one is all zeros."""
    if a.mask is None and b.mask is None:
        return None
    return torch.cat([x.mask if x.mask is not None else x.rgb.new_zeros(
        x.rgb.shape[:1] + x.rgb.shape[2:4], dtype=torch.float32) for x in (a, b)])
