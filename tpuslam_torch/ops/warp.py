"""Bilinear warp kernels K1-K5 (CUDA C++, `csrc/warp.cu`) and their plain
versions.

Counterparts of `tpuslam/ops/pallas_warp.py`:

* K1 `pallas_warp_static_fused` (`warp`): src (N, H, W, C) at coords
  (N, H, W, 2);
* K2 `pallas_warp_static` (`warp_two_kernel`): the two-kernel warp, whose
  forward is K1's launch without taps with f32 stores and whose backward
  gathers the taps again to write dcoords; with `trunc` its taps are
  truncated to bf16 as the packed and seg-skip variants gather them
  (`_pack_row_bf16`);
* K3 `pallas_warp` (`warp_dynamic`): the dynamic-window warp, which within
  its window computes K2's untruncated function, so it is K2 without
  `trunc`;
* K4 `pallas_warp_tall` (`warp_tall`): the 2*B distinct source frames, read
  through the index map n -> (n // (S*B)) * B + n % B of the
  [direction, scale, batch] stack, never tiled S-fold;
* K5 `pallas_warp_tall_proj` (`warp_tall_proj`): K4 with the coordinates
  computed in the kernel from depth (S*B, H, W, 1) and the affine camera maps
  ab (2*B, 12) of `geometry.camera.projection_affine`.

One forward kernel serves them all.  K1, K4 and K5 under autograd run it
with taps: it writes the warped image and the per-channel differentials
d(out)/dx, d(out)/dy, so the backward is the elementwise contraction
sum_c g * d, gated by `live` (1 inside, 0.5 at an exact edge, 0 outside),
with no second gather.  K5's backward then chains the coordinate cotangents
to depth and ab through autograd of the plain projection `proj_coords_plain`
(in the JAX package that chain is XLA, outside any kernel).  K2 and K3 run it
without taps and with f32 stores, and their backward is the second kernel,
`warp_grad_kernel`.  Without autograd every warp runs without taps.  Sources
get no gradient: camera images are inputs, never parameters.

The kernels are exact for any coordinates, like `bilinear_sampler`; the TPU
kernels clamp flow that leaves their source window.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel, on
its own device, or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tpuslam_torch import tracing
from tpuslam_torch.geometry.camera import bilinear_blend, bilinear_sampler, bilinear_taps
from tpuslam_torch.ops import build

# Launches of the CUDA kernel are the tracer's counters `launches.<entry>`
# (CPU calls are not counted): warp_static_fused (K1 with taps); warp_static,
# warp_static_trunc (K1 and K2 without taps, taps exact / truncated);
# warp_static_bwd, warp_static_bwd_trunc (K2's backward); warp_tall,
# warp_tall_notaps (K4); warp_tall_proj, warp_tall_proj_notaps (K5).

_PROJ_EPS = 1e-3  # z clamp of the projection, as geometry.camera.project_3d
_configured: Optional[ctypes.CDLL] = None


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types on `lib`."""
    lib.tpuslam_warp.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.tpuslam_warp_grad.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tpuslam_warp.restype = lib.tpuslam_warp_grad.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the warp kernel library."""
    global _configured
    if _configured is None:
        _configured = declare(build.load_library("warp"))
    return _configured


def _check_src(src: torch.Tensor, *others: torch.Tensor) -> None:
    if any(t.device != src.device for t in others):
        raise ValueError(f"inputs on {[str(t.device) for t in (src,) + others]}")
    if any(t.dtype != torch.float32 for t in (src,) + others):
        raise TypeError(f"warp takes float32, got {[t.dtype for t in (src,) + others]}")
    if src.dim() != 4 or src.shape[1] < 2 or src.shape[2] < 2:
        raise ValueError(f"warp needs H, W >= 2, got {tuple(src.shape)}")


def _check_coords(src: torch.Tensor, coords: torch.Tensor, S: int = 1, tall: bool = False) -> None:
    if tall and src.shape[0] % 2:
        raise ValueError(f"tall warp takes 2*B source frames, got {tuple(src.shape)}")
    if (coords.dim() != 4 or coords.shape[-1] != 2 or coords.shape[1:3] != src.shape[1:3]
            or coords.shape[0] != S * src.shape[0]):
        raise ValueError(f"coords {tuple(coords.shape)} do not match src "
                         f"{tuple(src.shape)} with S = {S}")
    _check_src(src, coords)


def _check_proj(src2: torch.Tensor, depth: torch.Tensor, ab: torch.Tensor, S: int) -> None:
    B = src2.shape[0] // 2
    if src2.shape[0] != 2 * B or ab.shape != (2 * B, 12):
        raise ValueError(f"expected src2 (2B, H, W, C) and ab (2B, 12): "
                         f"{tuple(src2.shape)}, {tuple(ab.shape)}")
    if depth.shape != (S * B,) + tuple(src2.shape[1:3]) + (1,):
        raise ValueError(f"depth {tuple(depth.shape)} is not (S*B, H, W, 1) for "
                         f"src2 {tuple(src2.shape)}, S = {S}")
    _check_src(src2, depth, ab)


def _launch(src, coords, depth, ab, N: int, S: int, B: int, with_taps: bool, bf16_out: bool,
            trunc: bool = False):
    _check_contiguous(src, coords, depth, ab)
    _, H, W, C = src.shape
    if N > 65535 or H > 65535 or H * W * C >= 2**31:
        raise ValueError(f"the warp kernel takes N, H <= 65535 and H * W * C < 2^31, "
                         f"got N = {N} and src {tuple(src.shape)}")
    lib = load_library()
    dtype = torch.bfloat16 if bf16_out else torch.float32
    outs = [torch.empty((N, H, W, C), dtype=dtype, device=src.device)
            for _ in range(3 if with_taps else 1)]
    ptr = [t.data_ptr() if t is not None else None for t in (coords, depth, ab)]
    dx = outs[1].data_ptr() if with_taps else None
    dy = outs[2].data_ptr() if with_taps else None
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpuslam_warp(src.data_ptr(), *ptr, outs[0].data_ptr(), dx, dy,
                               N, H, W, C, S, B, int(with_taps), int(bf16_out), int(trunc),
                               stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: CUDA error {err} (1 is the refusal of "
                           f"too many channels for a block's staging: tpuslam_warp, csrc/warp.cu)")
    return outs


def _launch_grad(src, coords, g, trunc: bool) -> torch.Tensor:
    _check_contiguous(src, coords, g)
    lib = load_library()
    N, H, W, C = src.shape
    dcoords = torch.empty((N, H, W, 2), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tpuslam_warp_grad(src.data_ptr(), coords.data_ptr(), g.data_ptr(),
                                    dcoords.data_ptr(), N, H, W, C, int(trunc), stream)
    if err != 0:
        raise RuntimeError(f"warp backward kernel launch failed: CUDA error {err}")
    return dcoords


def _check_contiguous(*tensors) -> None:
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError("warp kernels take contiguous inputs")


def _stored(outs, bf16_out: bool):
    dtype = torch.bfloat16 if bf16_out else torch.float32
    return tuple(t.to(dtype) for t in outs)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


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


def trunc_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 values truncated to bf16 toward zero, kept as f32: the low 16 bits
    of each word cleared, as `_pack_row_bf16` packs the taps (not rounded to
    nearest like a cast)."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def warp_two_kernel_plain(src: torch.Tensor, coords: torch.Tensor,
                          trunc: bool = False) -> torch.Tensor:
    """Plain version of K2's forward (and K3's, without `trunc`):
    `bilinear_sampler` of the source, its values truncated to bf16 when
    `trunc`."""
    return bilinear_sampler(trunc_bf16(src) if trunc else src, coords)


def warp_grad_plain(src: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                    trunc: bool = False) -> torch.Tensor:
    """Plain version of K2's backward (and K3'): the tap contraction of
    `warp_static_fused_plain` on the (truncated) source with the cotangent g
    (N, H, W, C), gated by `live` -> dcoords (N, H, W, 2) f32."""
    _, dx, dy = warp_static_fused_plain(trunc_bf16(src) if trunc else src, coords)
    return live_coords_grad(coords, *contract_taps(g, dx, dy))


def tall_sources(src2: torch.Tensor, S: int) -> torch.Tensor:
    """The (2*S*B, H, W, C) source stack that K4's index map reads: output n
    takes src2[(n // (S*B)) * B + n % B] (`_tall_specs`, pallas_warp.py)."""
    B = src2.shape[0] // 2
    n = torch.arange(2 * S * B, device=src2.device)
    return src2[(n // (S * B)) * B + n % B]


def warp_tall_plain(src2: torch.Tensor, coords: torch.Tensor, S: int):
    """Plain version of K4 with taps: the index map, then
    `warp_static_fused_plain`.  Without taps: `bilinear_sampler` of
    `tall_sources`."""
    return warp_static_fused_plain(tall_sources(src2, S), coords)


def proj_coords_plain(depth: torch.Tensor, ab: torch.Tensor, S: int) -> torch.Tensor:
    """The coordinates K5 computes in its prologue, (2*S*B, H, W, 2): the
    counterpart of `proj_coords_xla` (pallas_warp.py) with `_proj_xy`'s
    formula and order.  Differentiable in depth and ab."""
    SB, H, W = depth.shape[:3]
    B = ab.shape[0] // 2
    d = depth[..., 0].repeat(2, 1, 1)  # (2SB, H, W)
    n = torch.arange(2 * SB, device=depth.device)
    abn = ab[(n // (S * B)) * B + n % B]  # (2SB, 12)
    a = [abn[:, k, None, None] for k in range(12)]
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[None, :, None]
    rx = a[0] * u + a[1] * v + a[2]
    ry = a[3] * u + a[4] * v + a[5]
    rz = a[6] * u + a[7] * v + a[8]
    cx = d * rx + a[9]
    cy = d * ry + a[10]
    cz = d * rz + a[11]
    z = torch.clamp_min(cz, _PROJ_EPS)
    return torch.stack([cx / z, cy / z], dim=-1)


def warp_tall_proj_plain(src2, depth, ab, S: int):
    """Plain version of K5 with taps: `warp_tall_plain` at
    `proj_coords_plain`."""
    return warp_tall_plain(src2, proj_coords_plain(depth, ab, S), S)


# ---------------------------------------------------------------------------
# Kernel wrappers: plain version on the CPU, the kernel on CUDA
# ---------------------------------------------------------------------------


def warp_static_fused(src, coords, bf16_out: bool = False):
    """K1 with taps: (out, dx, dy), stored as bf16 when `bf16_out`."""
    _check_coords(src, coords)
    if src.device.type == "cpu":
        with torch.no_grad():
            return _stored(warp_static_fused_plain(src, coords), bf16_out)
    outs = _launch(src, coords, None, None, src.shape[0], 1, src.shape[0], True, bf16_out)
    tracing.count("launches.warp_static_fused")
    return tuple(outs)


def warp_static(src, coords, bf16_out: bool = False, trunc: bool = False):
    """K1 without taps, and K2's forward: the warped image, stored as bf16
    when `bf16_out`; with `trunc` (f32 stores only) the taps are truncated
    to bf16."""
    _check_coords(src, coords)
    if trunc and bf16_out:
        raise ValueError("truncated taps are stored as f32 only")
    if src.device.type == "cpu":
        with torch.no_grad():
            return _stored((warp_two_kernel_plain(src, coords, trunc),), bf16_out)[0]
    out = _launch(src, coords, None, None, src.shape[0], 1, src.shape[0], False, bf16_out,
                  trunc)[0]
    tracing.count("launches.warp_static_trunc" if trunc else "launches.warp_static")
    return out


def warp_static_bwd(src, coords, g, trunc: bool = False):
    """K2's backward: dcoords (N, H, W, 2) f32 for the cotangent g of the
    warped image, the taps gathered again (truncated when `trunc`)."""
    _check_coords(src, coords)
    if g.shape != src.shape or g.dtype != torch.float32 or g.device != src.device:
        raise ValueError(f"g must be f32 {tuple(src.shape)} on {src.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if src.device.type == "cpu":
        with torch.no_grad():
            return warp_grad_plain(src, coords, g, trunc)
    dcoords = _launch_grad(src, coords, g, trunc)
    tracing.count("launches.warp_static_bwd_trunc" if trunc else "launches.warp_static_bwd")
    return dcoords


def warp_tall_taps(src2, coords, S: int, bf16_out: bool = False):
    """K4 with taps: (out, dx, dy) of the (2*S*B, H, W, C) stack."""
    _check_coords(src2, coords, S, tall=True)
    if src2.device.type == "cpu":
        with torch.no_grad():
            return _stored(warp_tall_plain(src2, coords, S), bf16_out)
    B = src2.shape[0] // 2
    outs = _launch(src2, coords, None, None, 2 * S * B, S, B, True, bf16_out)
    tracing.count("launches.warp_tall")
    return tuple(outs)


def warp_tall_notaps(src2, coords, S: int, bf16_out: bool = False):
    """K4 without taps: the warped (2*S*B, H, W, C) stack."""
    _check_coords(src2, coords, S, tall=True)
    if src2.device.type == "cpu":
        with torch.no_grad():
            return _stored((bilinear_sampler(tall_sources(src2, S), coords),), bf16_out)[0]
    B = src2.shape[0] // 2
    out = _launch(src2, coords, None, None, 2 * S * B, S, B, False, bf16_out)[0]
    tracing.count("launches.warp_tall_notaps")
    return out


def warp_tall_proj_taps(src2, depth, ab, S: int, bf16_out: bool = False):
    """K5 with taps: (out, dx, dy), the coordinates computed in the kernel."""
    _check_proj(src2, depth, ab, S)
    if src2.device.type == "cpu":
        with torch.no_grad():
            return _stored(warp_tall_proj_plain(src2, depth, ab, S), bf16_out)
    B = src2.shape[0] // 2
    outs = _launch(src2, None, depth, ab, 2 * S * B, S, B, True, bf16_out)
    tracing.count("launches.warp_tall_proj")
    return tuple(outs)


def warp_tall_proj_notaps(src2, depth, ab, S: int, bf16_out: bool = False):
    """K5 without taps: the warped stack, the coordinates computed in the
    kernel."""
    _check_proj(src2, depth, ab, S)
    if src2.device.type == "cpu":
        with torch.no_grad():
            coords = proj_coords_plain(depth, ab, S)
            return _stored((bilinear_sampler(tall_sources(src2, S), coords),), bf16_out)[0]
    B = src2.shape[0] // 2
    out = _launch(src2, None, depth, ab, 2 * S * B, S, B, False, bf16_out)[0]
    tracing.count("launches.warp_tall_proj_notaps")
    return out


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


def live(v: torch.Tensor, hi: float) -> torch.Tensor:
    """Clip subgradient: 1 strictly inside (0, hi), 0.5 at an exact edge."""
    inside = ((v > 0.0) & (v < hi)).float()
    tie = ((v == 0.0) | (v == hi)).float()
    return inside + 0.5 * tie


def contract_taps(g: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor):
    """sum_c g * d for both tap differentials, in f32 -> two (N, H, W)."""
    gf = g.float()
    return (gf * dx.float()).sum(-1), (gf * dy.float()).sum(-1)


def live_coords_grad(coords: torch.Tensor, dcx: torch.Tensor, dcy: torch.Tensor):
    """Coordinate cotangent (N, H, W, 2) from the raw contractions, gated by
    `live` at the image bounds."""
    H, W = coords.shape[1:3]
    return torch.stack([dcx * live(coords[..., 0], W - 1),
                        dcy * live(coords[..., 1], H - 1)], dim=-1)


def proj_vjp_chain(depth, ab, dcx, dcy, S: int):
    """Chain the raw coordinate cotangents (2*S*B, H, W) to (d depth, d ab)
    through autograd of `proj_coords_plain`, with `live` applied to the
    recomputed coordinates (`proj_vjp_chain`, pallas_warp.py)."""
    with torch.enable_grad():
        d = depth.detach().requires_grad_()
        a = ab.detach().requires_grad_()
        coords = proj_coords_plain(d, a, S)
        dcoords = live_coords_grad(coords.detach(), dcx, dcy)
        return torch.autograd.grad(coords, (d, a), dcoords)


class WarpFused(torch.autograd.Function):
    """K1 or K4 with the fused gradient (`_fused_bwd`, `_tall_bwd`): the
    forward (`taps`: `warp_static_fused` or `warp_tall_taps`, called with
    `args` after the coordinates) stores the tap differentials, the backward
    contracts them with the incoming gradient."""

    @staticmethod
    def forward(ctx, taps, src, coords, *args):
        out, dx, dy = taps(src, coords.detach(), *args)
        ctx.save_for_backward(coords, dx, dy)
        ctx.n_args = len(args)
        return out

    @staticmethod
    def backward(ctx, g):
        coords, dx, dy = ctx.saved_tensors
        dcoords = live_coords_grad(coords, *contract_taps(g, dx, dy))
        return (None, None, dcoords) + (None,) * ctx.n_args


class WarpRecompute(torch.autograd.Function):
    """K2, the two-kernel warp (`_static_fwd` / `_static_bwd`): the forward
    stores only the f32 warped image; the backward gathers the taps again
    and writes dcoords."""

    @staticmethod
    def forward(ctx, src, coords, trunc: bool):
        ctx.save_for_backward(src, coords)
        ctx.trunc = trunc
        return warp_static(src, coords.detach(), False, trunc)

    @staticmethod
    def backward(ctx, g):
        src, coords = ctx.saved_tensors
        return None, warp_static_bwd(src, coords, g.float().contiguous(), ctx.trunc), None


class WarpTallProj(torch.autograd.Function):
    """K5 with the fused gradient (`_tall_proj_fwd` / `_tall_proj_bwd`):
    the tap contraction, then the projection chain to depth and ab."""

    @staticmethod
    def forward(ctx, src2, depth, ab, S: int, bf16_out: bool):
        out, dx, dy = warp_tall_proj_taps(src2, depth.detach(), ab.detach(), S, bf16_out)
        ctx.save_for_backward(depth, ab, dx, dy)
        ctx.S = S
        return out

    @staticmethod
    def backward(ctx, g):
        depth, ab, dx, dy = ctx.saved_tensors
        ddepth, dab = proj_vjp_chain(depth, ab, *contract_taps(g, dx, dy), ctx.S)
        return None, ddepth, dab, None, None


def grad_wanted(*tensors: torch.Tensor) -> bool:
    """Whether autograd is recording a gradient to any of `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def warp(src: torch.Tensor, coords: torch.Tensor, bf16_out: bool = False) -> torch.Tensor:
    """Bilinear border-clamped warp of src (N, H, W, C) at pixel coords
    (N, H, W, 2): K1 with taps when a gradient to `coords` is being
    recorded, K1 without taps otherwise."""
    if grad_wanted(coords):
        return WarpFused.apply(warp_static_fused, src, coords, bf16_out)
    return warp_static(src, coords, bf16_out)


def warp_two_kernel(src: torch.Tensor, coords: torch.Tensor, trunc: bool = False) -> torch.Tensor:
    """The two-kernel warp (K2) of src (N, H, W, C) at coords (N, H, W, 2),
    stored in f32: under autograd the backward is K2's gather kernel; with
    `trunc` both kernels read the taps truncated to bf16."""
    if grad_wanted(coords):
        return WarpRecompute.apply(src, coords, trunc)
    return warp_static(src, coords, False, trunc)


def warp_dynamic(src: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The dynamic-window warp (K3, `pallas_warp`, and K3' under autograd),
    exact for any coordinates: K2 with exact taps."""
    return warp_two_kernel(src, coords)


def warp_tall(src2: torch.Tensor, coords: torch.Tensor, S: int,
              bf16_out: bool = False) -> torch.Tensor:
    """Warp of the 2*B distinct sources src2 at the (2*S*B, H, W, 2) stack of
    coordinates: K4 with taps under autograd, without taps otherwise."""
    if grad_wanted(coords):
        return WarpFused.apply(warp_tall_taps, src2, coords, S, bf16_out)
    return warp_tall_notaps(src2, coords, S, bf16_out)


def warp_tall_proj(src2: torch.Tensor, depth: torch.Tensor, ab: torch.Tensor, S: int,
                   bf16_out: bool = False) -> torch.Tensor:
    """Warp of src2 at the coordinates that depth (S*B, H, W, 1) and the
    affine maps ab (2*B, 12) give: K5 with taps under autograd (gradients to
    depth and ab), without taps otherwise."""
    if grad_wanted(depth, ab):
        return WarpTallProj.apply(src2, depth, ab, S, bf16_out)
    return warp_tall_proj_notaps(src2, depth, ab, S, bf16_out)
