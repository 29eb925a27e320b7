"""SSIM + L1 error-map kernels K6, K6' and K7/K8 (CUDA C++, `csrc/reproj.cu`),
their plain versions, and the fused warp -> error-map composites.

Counterparts of `tpuslam/ops/pallas_loss.py::pallas_reproj_err` (K6, and
K6' its recompute backward) and `tpuslam/ops/pallas_fused.py`
(`warp_reproj_err`, `warp_reproj_err_proj`, whose one backward kernel K7/K8
recomputes d err / d pred and contracts it with the warp's stored tap
differentials, so dpred never reaches memory).

Error maps: pred n of the (N, H, W, C) stack, laid out [direction, scale,
batch], is compared with target n % B; err (N, H, W) f32 is the channel mean
of 0.85 * clamp((1 - SSIM) / 2, 0, 1) + 0.15 * |y - x| with reflect-padded
3x3 SSIM pools: `losses.photometric.reprojection_loss`.  Preds are bf16 or
f32 and are read as f32; the target gets no gradient.  The composites return
`(err, warped)` with `warped` detached: the loss reads the error maps, never
the warped images.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel, on
its own device, or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpuslam_torch import tracing
from tpuslam_torch.losses.photometric import reprojection_loss
from tpuslam_torch.ops import build
from tpuslam_torch.ops import warp as wp

# Launches of the CUDA kernels are the tracer's counters `launches.<entry>`
# (CPU calls are not counted): reproj_err (K6), reproj_err_bwd (K6'),
# err_bwd_coords (K7/K8).

_configured: Optional[ctypes.CDLL] = None


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types on `lib`."""
    lib.tpuslam_reproj_err.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tpuslam_reproj_err_bwd.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tpuslam_reproj_err.restype = ctypes.c_int
    lib.tpuslam_reproj_err_bwd.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the error-map library."""
    global _configured
    if _configured is None:
        _configured = declare(build.load_library("reproj"))
    return _configured


def _check(preds: torch.Tensor, target: torch.Tensor, g=None, dx=None, dy=None) -> None:
    others = [t for t in (target, g, dx, dy) if t is not None]
    if any(t.device != preds.device for t in others):
        raise ValueError(f"inputs on {[str(t.device) for t in [preds] + others]}")
    if preds.dtype not in (torch.float32, torch.bfloat16) or target.dtype != torch.float32:
        raise TypeError(f"preds f32 or bf16 and target f32, got {preds.dtype}, {target.dtype}")
    N, H, W, C = preds.shape
    B = target.shape[0]
    if target.shape != (B, H, W, C) or B == 0 or N % B:
        raise ValueError(f"preds {tuple(preds.shape)} and target {tuple(target.shape)}: "
                         f"need (k*B, H, W, C) and (B, H, W, C)")
    if H < 2 or W < 2:
        raise ValueError(f"the reflect-padded pools need H, W >= 2, got {(H, W)}")
    if preds.is_cuda and (N > 65535 or H * W * C >= 2**31):
        raise ValueError(f"the kernels take N <= 65535 images of H * W * C < 2^31 values, "
                         f"got {tuple(preds.shape)}")
    if g is not None and (g.shape != (N, H, W) or g.dtype != torch.float32):
        raise ValueError(f"g must be (N, H, W) f32, got {tuple(g.shape)} {g.dtype}")
    for t in (dx, dy):
        if t is not None and (t.shape != preds.shape or t.dtype != preds.dtype):
            raise ValueError(f"taps must match preds, got {tuple(t.shape)} {t.dtype}")


def _stream_call(fn, device, *args):
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("error-map kernels take contiguous inputs")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"error-map kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _targets(target: torch.Tensor, N: int) -> torch.Tensor:
    """Target of each pred: row n % B (`_window_specs`, pallas_loss.py)."""
    return target.repeat(N // target.shape[0], 1, 1, 1)


def reproj_err_plain(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: `reprojection_loss` of the preds read as f32
    against target n % B -> (N, H, W) f32.  Differentiable in preds."""
    return reprojection_loss(preds.float(), _targets(target, preds.shape[0]))


def reproj_err_bwd_plain(preds, target, g) -> torch.Tensor:
    """Plain version of K6' before its cast: autograd of `reproj_err_plain`,
    d err / d pred as (N, H, W, C) f32."""
    with torch.enable_grad():
        p = preds.detach().float().requires_grad_()
        (dp,) = torch.autograd.grad(reproj_err_plain(p, target), p, g)
    return dp


def err_bwd_coords_plain(preds, target, g, dx, dy) -> torch.Tensor:
    """Plain version of K7/K8: the f32 dpred contracted with the taps,
    (N, 2, H, W) f32, without the boundary mask."""
    dp = reproj_err_bwd_plain(preds, target, g)
    return torch.stack(wp.contract_taps(dp, dx, dy), dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers: plain version on the CPU, the kernel on CUDA
# ---------------------------------------------------------------------------


def reproj_err_fwd(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """K6: the (N, H, W) f32 error maps."""
    _check(preds, target)
    if preds.device.type == "cpu":
        with torch.no_grad():
            return reproj_err_plain(preds, target)
    N, H, W, C = preds.shape
    err = torch.empty((N, H, W), dtype=torch.float32, device=preds.device)
    _stream_call(load_library().tpuslam_reproj_err, preds.device, preds, target, err,
                 N, target.shape[0], H, W, C, int(preds.dtype == torch.bfloat16))
    tracing.count("launches.reproj_err")
    return err


def reproj_err_bwd(preds, target, g) -> torch.Tensor:
    """K6': d err / d pred for the error cotangent g, cast to preds' dtype
    (`_bwd`, pallas_loss.py)."""
    _check(preds, target, g)
    if preds.device.type == "cpu":
        return reproj_err_bwd_plain(preds, target, g).to(preds.dtype)
    N, H, W, C = preds.shape
    dpred = torch.empty_like(preds)
    _stream_call(load_library().tpuslam_reproj_err_bwd, preds.device, preds, target, g,
                 None, None, dpred, None, N, target.shape[0], H, W, C,
                 int(preds.dtype == torch.bfloat16))
    tracing.count("launches.reproj_err_bwd")
    return dpred


def err_bwd_coords(preds, target, g, dx, dy) -> torch.Tensor:
    """K7/K8: the raw coordinate cotangents (N, 2, H, W) f32, sum_c dpred_c
    * d_c with dpred in f32 and never stored (`_dc_from_err_bwd`)."""
    _check(preds, target, g, dx, dy)
    if preds.device.type == "cpu":
        return err_bwd_coords_plain(preds, target, g, dx, dy)
    N, H, W, C = preds.shape
    dc = torch.empty((N, 2, H, W), dtype=torch.float32, device=preds.device)
    _stream_call(load_library().tpuslam_reproj_err_bwd, preds.device, preds, target, g,
                 dx, dy, None, dc, N, target.shape[0], H, W, C,
                 int(preds.dtype == torch.bfloat16))
    tracing.count("launches.err_bwd_coords")
    return dc


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class ReprojErr(torch.autograd.Function):
    """Error maps with the recompute backward (`pallas_reproj_err`)."""

    @staticmethod
    def forward(ctx, preds, target):
        ctx.save_for_backward(preds, target)
        return reproj_err_fwd(preds, target)

    @staticmethod
    def backward(ctx, g):
        preds, target = ctx.saved_tensors
        return reproj_err_bwd(preds, target, g.float().contiguous()), None


class WarpReprojErr(torch.autograd.Function):
    """K4 then K6 forward; one K7 backward (`warp_reproj_err`)."""

    @staticmethod
    def forward(ctx, src2, coords, target, S: int, bf16_out: bool):
        out, dx, dy = wp.warp_tall_taps(src2, coords.detach(), S, bf16_out)
        err = reproj_err_fwd(out, target)
        ctx.save_for_backward(out, dx, dy, coords, target)
        ctx.mark_non_differentiable(out)
        ctx.set_materialize_grads(False)  # no zero cotangent for `warped`
        return err, out

    @staticmethod
    def backward(ctx, g_err, _g_warped):
        if g_err is None:
            return (None,) * 5
        out, dx, dy, coords, target = ctx.saved_tensors
        dc = err_bwd_coords(out, target, g_err.float().contiguous(), dx, dy)
        return None, wp.live_coords_grad(coords, dc[:, 0], dc[:, 1]), None, None, None


class WarpReprojErrProj(torch.autograd.Function):
    """K5 then K6 forward; one K8 backward, then the projection chain to
    depth and ab (`warp_reproj_err_proj`)."""

    @staticmethod
    def forward(ctx, src2, depth, ab, target, S: int, bf16_out: bool):
        out, dx, dy = wp.warp_tall_proj_taps(src2, depth.detach(), ab.detach(), S, bf16_out)
        err = reproj_err_fwd(out, target)
        ctx.save_for_backward(out, dx, dy, depth, ab, target)
        ctx.mark_non_differentiable(out)
        ctx.set_materialize_grads(False)
        ctx.S = S
        return err, out

    @staticmethod
    def backward(ctx, g_err, _g_warped):
        if g_err is None:
            return (None,) * 6
        out, dx, dy, depth, ab, target = ctx.saved_tensors
        dc = err_bwd_coords(out, target, g_err.float().contiguous(), dx, dy)
        ddepth, dab = wp.proj_vjp_chain(depth, ab, dc[:, 0], dc[:, 1], ctx.S)
        return None, ddepth, dab, None, None, None


def reproj_err(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Error maps (N, H, W) of preds against target n % B: K6, with K6' as
    its backward under autograd."""
    if wp.grad_wanted(preds):
        return ReprojErr.apply(preds, target)
    return reproj_err_fwd(preds, target)


def warp_reproj_err(src2, coords, target, S: int, bf16_out: bool = False):
    """K4 warp and K6 error maps -> (err, warped); under autograd the
    gradient reaches coords through err only, by one K7 backward."""
    if wp.grad_wanted(coords):
        return WarpReprojErr.apply(src2, coords, target, S, bf16_out)
    out = wp.warp_tall_notaps(src2, coords, S, bf16_out)
    return reproj_err_fwd(out, target), out


def warp_reproj_err_proj(src2, depth, ab, target, S: int, bf16_out: bool = False):
    """K5 warp (in-kernel projection) and K6 error maps -> (err, warped);
    under autograd the gradient reaches depth and ab through err only, by
    one K8 backward and the plain projection chain."""
    if wp.grad_wanted(depth, ab):
        return WarpReprojErrProj.apply(src2, depth, ab, target, S, bf16_out)
    out = wp.warp_tall_proj_notaps(src2, depth, ab, S, bf16_out)
    return reproj_err_fwd(out, target), out
