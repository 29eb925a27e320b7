"""Bilinear warp kernel K1 (CUDA C++, `csrc/warp.cu`) and its plain version.

Counterpart of `tpuslam/ops/pallas_warp.py::pallas_warp_static_fused`.  Under
autograd the kernel runs with taps: it writes the warped image and the
per-channel differentials d(out)/dx, d(out)/dy, so the backward is the
elementwise contraction sum_c g * d, gated by `live` (1 inside, 0.5 at an
exact edge, 0 outside), with no second gather.  Without autograd it runs
without taps (the TPU package's group-skip kernel).  Sources get no
gradient: camera images are inputs, never parameters.

The kernel is exact for any coordinates, like `bilinear_sampler`; the TPU
kernel clamps flow that leaves its (8 + 16 * extra_tiles)-row x 384-column
window, which is why `pallas_group_skip` and `pallas_extra_tiles` do not
apply here.

The library is built from the repository's sources with nvcc at first use
into `build/` and loaded with ctypes.  A CPU tensor takes the plain version
(`warp_static_fused_plain` with taps, `bilinear_sampler` without); a CUDA
tensor launches the kernel, on its own device, or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from tpuslam_torch.geometry.camera import bilinear_blend, bilinear_sampler, bilinear_taps

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "warp.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# Launch counts of the CUDA kernel (CPU calls are not counted): with taps
# (the autograd forward) and without (the no-grad warp).
warp_launches = 0
warp_notaps_launches = 0

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def reset_launches() -> None:
    global warp_launches, warp_notaps_launches
    warp_launches = 0
    warp_notaps_launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the warp kernel is built from source at first use")


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the warp kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libtpuslam_warp_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    lib.tpuslam_warp.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.tpuslam_warp.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(src: torch.Tensor, coords: torch.Tensor) -> None:
    if src.device != coords.device:
        raise ValueError(f"src on {src.device}, coords on {coords.device}")
    if src.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"warp takes float32, got {src.dtype} / {coords.dtype}")
    if src.dim() != 4 or coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"expected src (N,H,W,C), coords (N,H,W,2): "
                         f"{tuple(src.shape)}, {tuple(coords.shape)}")
    if coords.shape[:3] != src.shape[:3]:
        raise ValueError(f"coords {tuple(coords.shape)} do not match src {tuple(src.shape)}")
    if src.shape[1] < 2 or src.shape[2] < 2:
        raise ValueError(f"warp needs H, W >= 2, got {tuple(src.shape)}")


def _launch(src, coords, with_taps: bool, bf16_out: bool):
    if not (src.is_contiguous() and coords.is_contiguous()):
        raise ValueError("warp kernel takes contiguous src and coords")
    lib = load_library()
    N, H, W, C = src.shape
    dtype = torch.bfloat16 if bf16_out else torch.float32
    outs = [torch.empty(src.shape, dtype=dtype, device=src.device)
            for _ in range(3 if with_taps else 1)]
    out = outs[0]
    dx = outs[1].data_ptr() if with_taps else None
    dy = outs[2].data_ptr() if with_taps else None
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpuslam_warp(src.data_ptr(), coords.data_ptr(), out.data_ptr(), dx, dy,
                               N, H, W, C, int(with_taps), int(bf16_out), stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: CUDA error {err}")
    return outs


def warp_static_fused_plain(
    src: torch.Tensor, coords: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel with taps: (out, dx, dy) in f32.
    Without taps the plain version is `bilinear_sampler`.

    Differentiable in `coords`; its autograd gradient is the reference
    sampler's, 0.5 edge subgradient included."""
    a0, a1, b0, b1, wx, wy = taps = bilinear_taps(src, coords)
    out = bilinear_blend(*taps)
    dx = (a1 - a0) * (1 - wy) + (b1 - b0) * wy
    dy = (b0 - a0) * (1 - wx) + (b1 - a1) * wx
    return out, dx, dy


def warp_static_fused(src, coords, bf16_out: bool = False):
    """K1 with taps: (out, dx, dy), stored as bf16 when `bf16_out`."""
    global warp_launches
    _check(src, coords)
    if src.device.type == "cpu":
        dtype = torch.bfloat16 if bf16_out else torch.float32
        with torch.no_grad():
            return tuple(t.to(dtype) for t in warp_static_fused_plain(src, coords))
    outs = _launch(src, coords, True, bf16_out)
    warp_launches += 1
    return tuple(outs)


def warp_static(src, coords, bf16_out: bool = False):
    """K1 without taps: the warped image, stored as bf16 when `bf16_out`."""
    global warp_notaps_launches
    _check(src, coords)
    if src.device.type == "cpu":
        dtype = torch.bfloat16 if bf16_out else torch.float32
        with torch.no_grad():
            return bilinear_sampler(src, coords).to(dtype)
    out = _launch(src, coords, False, bf16_out)[0]
    warp_notaps_launches += 1
    return out


def _live(v: torch.Tensor, hi: float) -> torch.Tensor:
    """Clip subgradient: 1 strictly inside (0, hi), 0.5 at an exact edge."""
    inside = ((v > 0.0) & (v < hi)).float()
    tie = ((v == 0.0) | (v == hi)).float()
    return inside + 0.5 * tie


class WarpStaticFused(torch.autograd.Function):
    """Warp with the fused gradient: the forward stores the tap
    differentials, the backward contracts them with the incoming gradient."""

    @staticmethod
    def forward(ctx, src, coords, bf16_out: bool):
        out, dx, dy = warp_static_fused(src, coords.detach(), bf16_out)
        ctx.save_for_backward(coords, dx, dy)
        ctx.hw = src.shape[1:3]
        return out

    @staticmethod
    def backward(ctx, g):
        coords, dx, dy = ctx.saved_tensors
        H, W = ctx.hw
        gf = g.float()
        ddx = (gf * dx.float()).sum(-1) * _live(coords[..., 0], W - 1)
        ddy = (gf * dy.float()).sum(-1) * _live(coords[..., 1], H - 1)
        return None, torch.stack([ddx, ddy], dim=-1), None


def warp(src: torch.Tensor, coords: torch.Tensor, bf16_out: bool = False) -> torch.Tensor:
    """Bilinear border-clamped warp of src (N, H, W, C) at pixel coords
    (N, H, W, 2): K1 with taps when a gradient to `coords` is being
    recorded, K1 without taps otherwise."""
    if torch.is_grad_enabled() and coords.requires_grad:
        return WarpStaticFused.apply(src, coords, bf16_out)
    return warp_static(src, coords, bf16_out)
