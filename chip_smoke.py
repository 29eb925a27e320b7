#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tpuslam_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing lines tagged with its name and raising on failure
(exit code != 0):

1. device: the card's name and power limit;
2. build: both kernel libraries (tpuslam_torch/csrc/warp.cu, reproj.cu),
   one nvcc each, started together;
3. main: `Slam.step` with online adaptation on the synthetic world at
   192 x 640, ResNet-18 depth and pose, batch 3, K = 5, the shipped
   `pallas_*` defaults: K1 runs with taps on N = 2*S*B = 24 images;
4. profile: three more frames under torch.profiler give the host / device
   split of a frame;
5. eval: two frames with `adaptation: false` (batch 1): K1 without taps on
   N = 2*S = 8 images;
6. two-kernel main: twelve adapted frames with `pallas_fused_grad: false`:
   per frame 5 launches each of K2's forward and backward kernels with
   exact taps, and no K1 launch; two-kernel profile: three more frames
   under torch.profiler, beside the numbers of phase 4;
7. two-kernel eval: two frames of it with `adaptation: false`: one K2
   forward (f32) per frame;
8. packed main and seg-skip main: four and two adapted frames with
   `pallas_packed` and `pallas_seg_skip`: the same two kernels with
   bf16-truncated taps, 5 launches each per frame;
9. predictor: `DepthPosePrediction` (float32 networks, the two-kernel
   warp): `predict_from_images(return_loss=True)` on the card against the
   same call on the CPU, then one adapt of K = 5, with its launches;
10. fused main: the same adaptation with the fused stack (`pallas_tall`,
    `pallas_proj`, `pallas_fused_loss`, `pallas_fused_bwd`): per adapted
    frame 5 launches each of K5 with taps, K6 and K7/K8, and no other
    kernel of the port;
11. fused profile: three more frames of it under torch.profiler, beside
    the numbers of phase 4;
12. fused eval: two frames of the fused stack with `adaptation: false`: K5
    without taps and K6 once per frame each;
13. fused loss: four adapted frames with `pallas_tall` + `pallas_fused_loss`:
    5 launches per frame each of K4 with taps, K6 and K6';
14. kernels: every kernel (K1 with and without taps, K2's forward and
    backward with exact and truncated taps, K3 and K3', K4, K5 with and
    without taps, K6, K6', K7/K8) held against its plain torch version on
    adversarial inputs and on the inputs the paths gave it, then timed on
    the latter beside the plain version, the bound and, for the warps
    without taps and the backward gathers, torch's grid_sample forward and
    backward (K3 and K3' are K2 with exact taps, `warp_dynamic`: no path
    calls them, and their rows carry K2's numbers);
15. reference: one adaptation step on the card and on the CPU at a small
    size, with the K1 path, the fused stack, the two-kernel path and the
    packed variant (and the K1 path again at their size), which must agree.

During every path each plain version refuses CUDA tensors, and the
kernels' launch counts are set to 0 just before the path and read just
after it.

The last three lines are the kernels as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}.  Without CUDA, or without the
repository beside it, the script exits with an error and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
H, W, C = 192, 640, 3
S = 4  # scales
N_MAIN = 24  # images per warp in adapt_step: 2 directions x 4 scales x batch 3
N_EVAL = 8  # in eval_step (`adaptation: false`), where the batch is 1
# operations per pixel and channel of the SSIM + L1 error map (pools, moments,
# the SSIM ratio, L1): forward, and forward plus its adjoint
ERR_FLOPS, ERR_BWD_FLOPS = 60, 180
FUSED = dict(pallas_tall=True, pallas_proj=True, pallas_fused_loss=True,
             pallas_fused_bwd=True)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 50) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(inputs, outputs, flops: float):
    """Least time for the work: bytes moved once over HBM, or operations
    over the float32 peak, whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs) + list(outputs))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_bf16_ulps(got, want) -> float:
    """Largest |got - want| in units of one bf16 ulp of `want`, with |want|
    counted as at least 2^-10: near zero the f32 rounding of the taps
    (~1e-7) is larger than a bf16 ulp and is held to 2^-17 absolute."""
    import torch

    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())


def rel_err(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def max_abs(got, want) -> float:
    return float((got.detach().float() - want.detach().float()).abs().max())


def device_ms(torch, fn, match: str, iters: int = 20) -> float:
    """Mean device duration of the kernel whose name holds `match`, one
    launch of `fn` per iteration with the 50 MB L2 flushed before it (a
    256 MB write), read from torch.profiler's CUDA trace: no host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(2 ** 26, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    # the trace may miss the first launches after it starts (up to 4 of
    # them seen on the H100), and now and then it holds none of them (seen
    # once, for grid_sample): take a fresh one, at most three
    warm = 10
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(warm + iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and match in e.name)
        if iters <= len(spans) <= warm + iters:
            return sum(e - s for s, e in spans[-iters:]) / iters / 1e3
    raise AssertionError(f"profiler saw {len(spans)} '{match}' kernels in "
                         f"{warm + iters} calls, three times")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def warp_inputs(device, n: int, n_src: int = None):
    """n_src distinct images in [0, 1] (n by default) and n pixel-grid
    coordinate fields plus smooth random flow, with points outside the
    image, exact-edge ties and integer coordinates."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(n)
    src = torch.rand((n_src or n, H, W, C), generator=g, device=device)
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    coarse = torch.randn((n, 2, 6, 20), generator=g, device=device) * 6.0
    flow = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)
    coords = torch.stack([xs + flow[:, 0], ys + flow[:, 1]], dim=-1)
    coords[:, :, :8, 0] = -3.5  # left of the image
    coords[:, 100:104, :, 1] = H + 20.0  # below the image
    coords[:, 0, :, 1] = 0.0  # top edge, exact tie
    coords[:, :, -1, 0] = W - 1.0  # right edge, exact tie
    coords[:, 50:52] = torch.floor(coords[:, 50:52])  # integer coordinates
    return src, coords.contiguous()


def proj_inputs(device, B: int):
    """depth (S*B, H, W, 1) and affine maps (2B, 12) of a KITTI-like camera
    and small random poses, with a near region that projects outside the
    image and a far one; plus 2B source images."""
    import torch

    from tpuslam_torch.geometry.camera import projection_affine

    g = torch.Generator(device=device).manual_seed(B)
    src2 = torch.rand((2 * B, H, W, C), generator=g, device=device)
    depth = 2.0 + 30.0 * torch.rand((S * B, 1, 6, 20), generator=g, device=device)
    depth = torch.nn.functional.interpolate(depth, size=(H, W), mode="bilinear",
                                            align_corners=False).permute(0, 2, 3, 1)
    depth[:, :20, :] = 0.3  # near: leaves the image
    K = torch.eye(4, device=device).repeat(2 * B, 1, 1)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    T = torch.eye(4, device=device).repeat(2 * B, 1, 1)
    T[:, :3, 3] = 0.3 * torch.randn((2 * B, 3), generator=g, device=device)
    ab = projection_affine(K, torch.linalg.inv(K), T)
    return src2, depth.contiguous(), ab.contiguous()


def err_inputs(device, n: int, B: int):
    """preds (n, H, W, C), targets (B, H, W, C), error cotangent g and tap
    differentials, with: a region where pred equals its target exactly
    (|y - x| = 0) touching rows and columns 0 and 1; another touching rows
    and columns H-2, H-1 and W-2, W-1; constant equal patches (SSIM = 1 on
    the clamp's edge); and patches where pred is target scaled by 1 + 2^-20,
    where rounding puts SSIM above 1 and the clamp is active."""
    import torch

    g = torch.Generator(device=device).manual_seed(n + 100)
    target = torch.rand((B, H, W, C), generator=g, device=device)
    preds = torch.rand((n, H, W, C), generator=g, device=device)
    preds[0, :40, :100] = target[0, :40, :100]
    preds[1 % n, -30:, -50:] = target[1 % B, -30:, -50:]
    target[0, 60:90, 200:260] = 0.5
    preds[0, 60:90, 200:260] = 0.5
    preds[0, 100:130, 300:400] = target[0, 100:130, 300:400] * (1 + 2.0 ** -20)
    gerr = torch.randn((n, H, W), generator=g, device=device)
    taps = [torch.randn((n, H, W, C), generator=g, device=device) for _ in range(2)]
    return preds, target, gerr, taps


# ---------------------------------------------------------------------------
# Checks of each kernel against its plain version
# ---------------------------------------------------------------------------


def _require(ok: bool, what: str, err: dict) -> None:
    if not ok:
        raise AssertionError(f"{what}: {err}")


def _log_err(name: str, tag: str, shape, err: dict) -> None:
    log("kernels", f"{name} vs plain on {tag}, {tuple(shape)}: "
        + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))


def check_k1(torch, wp, src, coords, tag: str) -> dict:
    """K1 with and without taps, f32 and bf16 outputs, and its autograd
    backward, against the plain versions on the same inputs; raises beyond
    the tolerances: 1e-5 abs for f32 (FMA contraction), one bf16 ulp of the
    plain result rounded to bf16, 1e-4 relative for dcoords."""
    bf16 = torch.bfloat16
    plain = wp.warp_static_fused_plain(src, coords)
    got = wp.warp_static_fused(src, coords, False)
    got16 = wp.warp_static_fused(src, coords, True)
    plain_nt = wp.bilinear_sampler(src, coords)
    nt, nt16 = wp.warp_static(src, coords, False), wp.warp_static(src, coords, True)
    err = dict(
        taps_f32=max(max_abs(a, b) for a, b in zip(got, plain)),
        taps_bf16=max(max_abs(a, b.to(bf16)) for a, b in zip(got16, plain)),
        taps_bf16_ulps=max(max_bf16_ulps(a, b.to(bf16)) for a, b in zip(got16, plain)),
        notaps_f32=max_abs(nt, plain_nt),
        notaps_bf16=max_abs(nt16, plain_nt.to(bf16)),
        notaps_bf16_ulps=max_bf16_ulps(nt16, plain_nt.to(bf16)),
    )
    gout = torch.randn(src.shape, generator=torch.Generator(device=src.device).manual_seed(1),
                       device=src.device)
    ck = coords.clone().requires_grad_()
    (wp.warp(src, ck, False) * gout).sum().backward()
    cp = coords.clone().requires_grad_()
    (wp.warp_static_fused_plain(src, cp)[0] * gout).sum().backward()
    err["dcoords_rel"] = rel_err(ck.grad, cp.grad)
    _require(err["taps_f32"] <= 1e-5 and err["notaps_f32"] <= 1e-5
             and err["taps_bf16_ulps"] <= 1.0 and err["notaps_bf16_ulps"] <= 1.0
             and err["dcoords_rel"] <= 1e-4, f"K1 vs plain on {tag}", err)
    _log_err("K1", tag, src.shape, err)
    return err


def check_tall(torch, wp, src2, coords, tag: str) -> dict:
    """K4 with and without taps, f32 and bf16 outputs, and its autograd
    backward, against the plain versions (the index map plus K1's); the
    tolerances of K1."""
    bf16 = torch.bfloat16
    n_scales = coords.shape[0] // src2.shape[0]
    plain = wp.warp_tall_plain(src2, coords, n_scales)
    got = wp.warp_tall_taps(src2, coords, n_scales, False)
    got16 = wp.warp_tall_taps(src2, coords, n_scales, True)
    nt16 = wp.warp_tall_notaps(src2, coords, n_scales, True)
    err = dict(
        taps_f32=max(max_abs(a, b) for a, b in zip(got, plain)),
        taps_bf16_ulps=max(max_bf16_ulps(a, b.to(bf16)) for a, b in zip(got16, plain)),
        notaps_f32=max_abs(wp.warp_tall_notaps(src2, coords, n_scales, False), plain[0]),
        notaps_bf16=max_abs(nt16, plain[0].to(bf16)),
        notaps_bf16_ulps=max_bf16_ulps(nt16, plain[0].to(bf16)),
    )
    err["taps_bf16"] = max(max_abs(a, b.to(bf16)) for a, b in zip(got16, plain))
    gout = torch.randn(plain[0].shape, device=src2.device,
                       generator=torch.Generator(device=src2.device).manual_seed(2))
    ck = coords.clone().requires_grad_()
    (wp.warp_tall(src2, ck, n_scales, False) * gout).sum().backward()
    cp = coords.clone().requires_grad_()
    (wp.warp_tall_plain(src2, cp, n_scales)[0] * gout).sum().backward()
    err["dcoords_rel"] = rel_err(ck.grad, cp.grad)
    _require(err["taps_f32"] <= 1e-5 and err["notaps_f32"] <= 1e-5
             and err["taps_bf16_ulps"] <= 1.0 and err["notaps_bf16_ulps"] <= 1.0
             and err["dcoords_rel"] <= 1e-4, f"K4 vs plain on {tag}", err)
    _log_err("K4", tag, coords.shape, err)
    return err


def check_proj(torch, wp, src2, depth, ab, tag: str) -> dict:
    """K5 with and without taps, f32 and bf16 outputs, and its autograd
    backward (taps contracted in torch, then the plain projection chain) to
    depth and ab, against the plain versions; the tolerances of K1 (the
    kernel's coordinates equal the plain projection's bit for bit)."""
    bf16 = torch.bfloat16
    n_scales = depth.shape[0] // (src2.shape[0] // 2)
    plain = wp.warp_tall_proj_plain(src2, depth, ab, n_scales)
    got = wp.warp_tall_proj_taps(src2, depth, ab, n_scales, False)
    got16 = wp.warp_tall_proj_taps(src2, depth, ab, n_scales, True)
    nt16 = wp.warp_tall_proj_notaps(src2, depth, ab, n_scales, True)
    err = dict(
        taps_f32=max(max_abs(a, b) for a, b in zip(got, plain)),
        taps_bf16=max(max_abs(a, b.to(bf16)) for a, b in zip(got16, plain)),
        taps_bf16_ulps=max(max_bf16_ulps(a, b.to(bf16)) for a, b in zip(got16, plain)),
        notaps_f32=max_abs(wp.warp_tall_proj_notaps(src2, depth, ab, n_scales, False),
                           plain[0]),
        notaps_bf16=max_abs(nt16, plain[0].to(bf16)),
        notaps_bf16_ulps=max_bf16_ulps(nt16, plain[0].to(bf16)),
    )
    gout = torch.randn(plain[0].shape, device=src2.device,
                       generator=torch.Generator(device=src2.device).manual_seed(3))
    dk, ak = depth.clone().requires_grad_(), ab.clone().requires_grad_()
    (wp.warp_tall_proj(src2, dk, ak, n_scales, False) * gout).sum().backward()
    dp, ap = depth.clone().requires_grad_(), ab.clone().requires_grad_()
    (wp.warp_tall_proj_plain(src2, dp, ap, n_scales)[0] * gout).sum().backward()
    err["ddepth_rel"], err["dab_rel"] = rel_err(dk.grad, dp.grad), rel_err(ak.grad, ap.grad)
    _require(err["taps_f32"] <= 1e-5 and err["notaps_f32"] <= 1e-5
             and err["taps_bf16_ulps"] <= 1.0 and err["notaps_bf16_ulps"] <= 1.0
             and err["ddepth_rel"] <= 1e-4 and err["dab_rel"] <= 1e-4,
             f"K5 vs plain on {tag}", err)
    _log_err("K5", tag, depth.shape, err)
    return err


def _err_bwd64(torch, preds, target, g):
    """d err / d pred of the plain version evaluated in float64."""
    from tpuslam_torch.losses.photometric import reprojection_loss

    with torch.enable_grad():
        p = preds.detach().double().requires_grad_()
        t = target.double().repeat(preds.shape[0] // target.shape[0], 1, 1, 1)
        (d,) = torch.autograd.grad(reprojection_loss(p, t), p, g.double())
    return d


def check_err(torch, rp, preds, target, gerr, dx, dy, tag: str) -> dict:
    """K6, K6' and K7/K8 on f32 and bf16 preds (and taps) against the plain
    versions.  K6 within 1e-5 relative (norm) of the plain version; K6'
    bf16 stores within one bf16 ulp of the plain f32 result rounded to bf16.
    The f32 backward results are also held against the plain version in
    float64: within 1e-5 relative of it, or no further from it than twice
    the plain float32 version is (`rel64`).  On smooth images, where the
    SSIM denominator nears C1 * C2, the two float32 versions round apart by
    ~1e-5 (different expressions of one derivative), each about half that
    from the float64 value."""
    err = {}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        p, tx, ty = preds.to(dtype), dx.to(dtype), dy.to(dtype)
        e, ep = rp.reproj_err_fwd(p, target), rp.reproj_err_plain(p, target)
        err[f"K6_{key}_rel"], err[f"K6_{key}"] = rel_err(e, ep), max_abs(e, ep)
        d, dpl = rp.reproj_err_bwd(p, target, gerr), rp.reproj_err_bwd_plain(p, target, gerr)
        if d.dtype != dtype:
            raise AssertionError(f"K6' returned {d.dtype} for {dtype} preds")
        d64 = _err_bwd64(torch, p, target, gerr)
        if dtype == torch.float32:
            err["K6'_f32_rel"], err["K6'_f32"] = rel_err(d, dpl), max_abs(d, dpl)
            err["K6'_f32_rel64"], err["K6'_f32_plain_rel64"] = rel_err(d, d64), rel_err(dpl, d64)
        else:
            err["K6'_bf16_ulps"] = max_bf16_ulps(d, dpl.to(dtype))
            err["K6'_bf16"] = max_abs(d, dpl.to(dtype))
        dc, dcp = (rp.err_bwd_coords(p, target, gerr, tx, ty),
                   rp.err_bwd_coords_plain(p, target, gerr, tx, ty))
        dc64 = torch.stack([(d64 * t.double()).sum(-1) for t in (tx, ty)], dim=1)
        err[f"K7_{key}_rel"], err[f"K7_{key}"] = rel_err(dc, dcp), max_abs(dc, dcp)
        err[f"K7_{key}_rel64"], err[f"K7_{key}_plain_rel64"] = rel_err(dc, dc64), rel_err(dcp, dc64)
    close64 = all(err[f"{k}_rel64"] <= max(1e-5, 2 * err[f"{k}_plain_rel64"])
                  for k in ("K6'_f32", "K7_f32", "K7_bf16"))
    _require(err["K6_f32_rel"] <= 1e-5 and err["K6_bf16_rel"] <= 1e-5 and close64
             and err["K6'_bf16_ulps"] <= 1.0, f"error-map kernels vs plain on {tag}", err)
    _log_err("K6/K6'/K7", tag, preds.shape, err)
    return err


def _warp_grad64(torch, wp, src, coords, g, trunc: bool):
    """K2's backward evaluated in float64 on the (truncated) f32 source."""
    s = (wp.trunc_bf16(src) if trunc else src).double()
    _, dx, dy = wp.warp_static_fused_plain(s, coords.double())
    gd = g.double()
    return wp.live_coords_grad(coords.double(), (gd * dx).sum(-1), (gd * dy).sum(-1))


def check_k2(torch, wp, src, coords, g, tag: str) -> dict:
    """K2's forward and backward kernels (K3 and K3' with exact taps), with
    exact and truncated taps, against the plain versions: f32 values within
    1e-6 absolute; dcoords within 1e-5 relative of the plain version, or no
    further from its float64 value than twice the plain float32 version
    is."""
    err = {}
    for trunc, key in ((False, "exact"), (True, "trunc")):
        out = wp.warp_static(src, coords, False, trunc)
        plain = wp.warp_two_kernel_plain(src, coords, trunc)
        d, dp = wp.warp_static_bwd(src, coords, g, trunc), wp.warp_grad_plain(src, coords, g, trunc)
        d64 = _warp_grad64(torch, wp, src, coords, g, trunc)
        err[f"fwd_{key}"], err[f"bwd_{key}"] = max_abs(out, plain), max_abs(d, dp)
        err[f"bwd_{key}_rel"] = rel_err(d, dp)
        err[f"bwd_{key}_rel64"], err[f"bwd_{key}_plain_rel64"] = rel_err(d, d64), rel_err(dp, d64)
    close = all(err[f"bwd_{k}_rel"] <= 1e-5
                or err[f"bwd_{k}_rel64"] <= 2 * err[f"bwd_{k}_plain_rel64"]
                for k in ("exact", "trunc"))
    _require(err["fwd_exact"] <= 1e-6 and err["fwd_trunc"] <= 1e-6 and close,
             f"K2/K3 vs plain on {tag}", err)
    _log_err("K2/K3", tag, src.shape, err)
    return err


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------


class PathGuard:
    """While a path runs: a CUDA tensor must never reach a plain version,
    and the last inputs the path gave each kernel wrapper are kept (by
    reference: the path does not write to them afterwards)."""

    PLAIN = {"wp": ("warp_static_fused_plain", "bilinear_sampler", "warp_tall_plain",
                    "warp_tall_proj_plain", "warp_two_kernel_plain", "warp_grad_plain",
                    "trunc_bf16"),
             "rp": ("reproj_err_plain", "reproj_err_bwd_plain", "err_bwd_coords_plain")}
    WRAPPERS = {"wp": ("warp_static_fused", "warp_static", "warp_tall_taps",
                       "warp_tall_notaps", "warp_tall_proj_taps", "warp_tall_proj_notaps",
                       "warp_static_bwd"),
                "rp": ("reproj_err_fwd", "reproj_err_bwd", "err_bwd_coords")}

    def __init__(self, wp, rp, captured: dict):
        self.mods = {"wp": wp, "rp": rp}
        self.captured = captured
        self.orig = [(mod, name, getattr(self.mods[mod], name))
                     for group in (self.PLAIN, self.WRAPPERS)
                     for mod, names in group.items() for name in names]

    def __enter__(self):
        import torch

        def plain_guard(fn, name):
            def guarded(*args, **kwargs):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    raise AssertionError(f"a CUDA tensor reached the plain {name}")
                return fn(*args, **kwargs)
            return guarded

        def capture(fn, name):
            def kept(*args):
                self.captured[name] = args
                return fn(*args)
            return kept

        for mod, name, fn in self.orig:
            wrap = plain_guard if name in self.PLAIN[mod] else capture
            setattr(self.mods[mod], name, wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(self.mods[mod], name, fn)


def reset_launches(wp, rp) -> None:
    wp.reset_launches()
    rp.reset_launches()


def read_launches(wp, rp) -> dict:
    return {**wp.launches, **rp.launches}


def expect_launches(path: str, got: dict, want: dict) -> None:
    """Every kernel count of the path equals `want` (0 where not named)."""
    full = {k: want.get(k, 0) for k in got}
    if got != full or not set(want) <= set(got):
        raise AssertionError(f"{path}: launches {got}, expected {full}")


def smoke_config(log_dir: Path, adaptation: bool, height=H, width=W, **pc):
    from tpuslam_torch.config import Config
    from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig, SlamConfig

    cfg = Config()
    cfg.dataset = DatasetConfig(dataset="Synthetic", height=height, width=width,
                                num_frames=16)
    cfg.depth_pose = DepthPoseConfig(batch_size=3, resnet_depth=18, resnet_pose=18,
                                     log_path=log_dir, **pc)
    cfg.slam = SlamConfig(adaptation=adaptation, adaptation_epochs=5,
                          do_loop_closures=False, pipeline_depth=0, plot_frequency=0)
    return cfg


def run_adapt_path(torch, wp, rp, phase, log_dir, captured, card, steps, want, **pc):
    """`steps` frames of `Slam.step` with adaptation; checks losses, the pose
    graph and the launches (`want`: kernel -> launches per adapted frame).
    Returns the launches, the Slam and the mean time of frames 3 on (frames
    1-2 hold cuDNN autotuning and warm-up), None for runs of 2 frames."""
    import numpy as np

    from tpuslam_torch.slam import Slam

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier paths' inputs kept for phase kernels
    slam = Slam(smoke_config(log_dir, adaptation=True, **pc), device="cuda")
    losses = []
    reset_launches(wp, rp)
    with PathGuard(wp, rp, captured):
        for _ in range(steps):
            losses.append(slam.step())
    launches = read_launches(wp, rp)
    adapted = len(slam.step_times)
    bad = [l for l in losses if not all(math.isfinite(v) for v in l.values())]
    if bad or adapted == 0:
        raise AssertionError(f"{phase}: non-finite losses {bad} or no adapted frame")
    if slam.pose_graph.vertex_ids != list(range(adapted + 1)):
        raise AssertionError(f"{phase}: pose graph vertices {slam.pose_graph.vertex_ids}")
    expect_launches(phase, launches, {k: v * adapted for k, v in want.items()})
    ms = 1e3 * float(np.mean(slam.step_times[2:])) if adapted > 2 else None
    steady = (f"steady {ms:.2f} ms/frame = {1e3 / ms:.2f} frames/s (frames 3-{adapted})"
              if ms is not None else "no steady time (warm-up frames only)")
    log(phase, f"{adapted} frames adapted, loss {losses[-1]['loss']:.5f}, launches "
        f"{ {k: v for k, v in launches.items() if v} }, replay buffer "
        f"{len(slam.replay_buffer)}, {steady}, peak memory "
        f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before the path [{card}]")
    return launches, slam, ms


def run_eval_path(torch, wp, rp, phase, log_dir, captured, want, **pc):
    """Two frames with `adaptation: false`; `want`: kernel -> launches."""
    from tpuslam_torch.slam import Slam

    slam = Slam(smoke_config(log_dir, adaptation=False, **pc), device="cuda")
    reset_launches(wp, rp)
    with PathGuard(wp, rp, captured):
        losses = [slam.step() for _ in range(2)]
    launches = read_launches(wp, rp)
    if not all(math.isfinite(l["loss"]) for l in losses):
        raise AssertionError(f"{phase}: losses {losses}")
    expect_launches(phase, launches, want)
    log(phase, f"2 frames, loss {losses[-1]['loss']:.5f}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def phase_predictor(torch, wp, rp, log_dir: Path, captured: dict, card: str) -> dict:
    """`DepthPosePrediction` at 192 x 640, float32 networks, the two-kernel
    warp: `predict_from_images(return_loss=True)` on the card against the
    same call on the CPU from the same weights (depths, pose and loss within
    1e-3 relative: cuDNN sums in another order), then one adapt of K = 5 on
    a batch of 3; returns the launches."""
    import warnings

    import numpy as np

    from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig
    from tpuslam_torch.data.synthetic import SyntheticDataset
    from tpuslam_torch.predictor import DepthPosePrediction
    from tpuslam_torch.train.batch import concat_batches, make_frame_batch

    ds = SyntheticDataset(num_frames=6, height=H, width=W)
    dc = DatasetConfig(dataset="Synthetic", height=H, width=W)
    pc = DepthPoseConfig(batch_size=3, log_path=log_dir, dtype="float32", pallas_fused_grad=False)
    s = ds[1]
    calib = dict(return_loss=True, camera_matrix=s.K, inv_camera_matrix=np.linalg.inv(s.K),
                 relative_distance=s.rel_dist[0])
    warnings.filterwarnings("ignore", "The model has not been trained yet")
    want = DepthPosePrediction(dc, pc, device="cpu").predict_from_images(s.rgb[0], s.rgb[1], **calib)
    pred = DepthPosePrediction(dc, pc, device="cuda")
    online = make_frame_batch(s.rgb[None], s.K, s.rel_dist[None], device="cuda")
    replay = [ds[2], ds[3]]
    training = concat_batches(online, make_frame_batch(
        np.stack([r.rgb for r in replay]), np.stack([r.K for r in replay]),
        np.stack([r.rel_dist for r in replay]), device="cuda"))
    reset_launches(wp, rp)
    with PathGuard(wp, rp, captured):
        got = pred.predict_from_images(s.rgb[0], s.rgb[1], **calib)
        outputs, losses = pred.adapt(online, training, steps=5)
        packed = outputs[("retire_packed",)].cpu().numpy()
    launches = read_launches(wp, rp)
    err = dict(depth_0=rel_err(torch.from_numpy(got[0]), torch.from_numpy(want[0])),
               depth_1=rel_err(torch.from_numpy(got[1]), torch.from_numpy(want[1])),
               pose=rel_err(torch.from_numpy(got[2]), torch.from_numpy(want[2])),
               loss=abs(got[3]["loss"] - want[3]["loss"]) / abs(want[3]["loss"]))
    _require(max(err.values()) <= 1e-3 and np.all(np.isfinite(packed)),
             "predictor: card vs CPU", err)
    expect_launches("predictor", launches, {"warp_static": 6, "warp_static_bwd": 5})
    log("predictor", f"predict_from_images(return_loss=True) card vs CPU: "
        + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
        + f"; probe loss {got[3]['loss']:.5f}; adapt K=5 loss {float(losses['loss']):.5f}; "
        f"launches { {k: v for k, v in launches.items() if v} } [{card}]")
    return launches


def phase_profile(torch, slam, card: str, phase: str, frames: int = 3) -> dict:
    """Where a frame's time goes: host time making the synthetic frame,
    the rest of `Slam.step`, and the device's busy time (union of the
    kernel and copy intervals that torch.profiler records) by kernel."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data_s = 0.0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            t = time.perf_counter()
            sample = slam.dataset[slam.current_step]
            data_s += time.perf_counter() - t
            slam.step(sample)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    by_name = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.end - e.time_range.start
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    wall_ms, busy_ms = 1e3 * wall_s / frames, busy_us / 1e3 / frames
    if busy_ms <= 0.0:
        log(phase, f"{wall_ms:.2f} ms/frame wall; device time not measured "
            f"(the profiler recorded no device activity) [{card}]")
        return dict(wall_ms=wall_ms)
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms,
               activities=len(spans) / frames, data_ms=1e3 * data_s / frames)
    top = ", ".join(f"{name[:60]} {us / 1e3 / frames:.3f}" for name, us in by_name.most_common(8))
    log(phase, f"{frames} frames: wall {wall_ms:.2f} ms/frame, synthetic frame "
        f"{out['data_ms']:.2f} ms/frame, device busy {busy_ms:.2f} ms/frame "
        f"(idle share {out['idle']:.3f}), {out['activities']:.0f} device "
        f"activities/frame [{card}]")
    log(phase, f"top device time, ms/frame: {top}")
    return out


def phase_reference(torch, log_dir: Path, tag: str, height=64, width=192, **pc):
    """One adapt_step on the card (kernels) and on the CPU (plain versions)
    from the same weights and batch, at 64 x 192 (64 x 384 for the
    two-kernel routes, inside the gate where the packed taps truncate),
    float32, noise off.  cuDNN sums in another order than the CPU, and
    Adam's first step normalises each gradient, so the two agree to ~1e-5,
    not to the last bit."""
    import numpy as np

    from tpuslam_torch.data.synthetic import SyntheticDataset
    from tpuslam_torch.models.depth_pose import init_depth_pose
    from tpuslam_torch.train.batch import make_frame_batch, pad_batch
    from tpuslam_torch.train.state import make_adapt_optimizer, make_train_state
    from tpuslam_torch.train.steps import adapt_step, loss_config

    pcfg = smoke_config(log_dir, True, height, width, dtype="float32",
                        pallas_bf16_out=False, **pc).depth_pose
    cfg = loss_config(pcfg)
    sample = SyntheticDataset(num_frames=4, height=height, width=width)[1]
    packed = {}
    for dev in ("cuda", "cpu"):
        model = init_depth_pose(0, device=dev)
        state = make_train_state(model, make_adapt_optimizer(model, 1e-4), seed=None)
        batch = pad_batch(make_frame_batch(sample.rgb[None], sample.K, sample.rel_dist[None],
                                           device=dev), 3)
        _, outputs = adapt_step(state, cfg, batch, num_steps=2, with_lc_embedding=False)
        packed[dev] = outputs[("retire_packed",)].cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(packed["cuda"] - packed["cpu"]) / np.linalg.norm(packed["cpu"]))
    if not (np.all(np.isfinite(packed["cuda"])) and rel <= 1e-3):
        raise AssertionError(f"adapt_step ({tag}) card vs CPU: relative error {rel} > 1e-3")
    log("reference", f"adapt_step ({tag}) {height}x{width} K=2 float32, card vs CPU packed "
        f"readback: relative error {rel:.3g}")


# ---------------------------------------------------------------------------
# Kernels: checks and times
# ---------------------------------------------------------------------------


def _grid_sample_ms(torch, src, coords):
    """torch's grid_sample on the same warp (no taps): device and back-to-
    back times.  A yardstick only; the port never calls it."""
    import torch.nn.functional as F

    grid = torch.stack([coords[..., 0] / (W - 1) * 2 - 1,
                        coords[..., 1] / (H - 1) * 2 - 1], -1)
    src_nchw = src.permute(0, 3, 1, 2).contiguous()

    def grid_sample():
        return F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    return device_ms(torch, grid_sample, "grid_sampler"), time_ms(grid_sample)


def _grid_sample_bwd_ms(torch, src, coords, g):
    """torch's grid_sample backward, the grid gradient only (the gather
    K2's backward kernel does), on the same warp: device and back-to-back
    times.  A yardstick only; the port never calls it."""
    grid = torch.stack([coords[..., 0] / (W - 1) * 2 - 1,
                        coords[..., 1] / (H - 1) * 2 - 1], -1)
    src_nchw = src.permute(0, 3, 1, 2).contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous()

    def backward():  # bilinear (0), border padding (1), align_corners
        return torch.ops.aten.grid_sampler_2d_backward(g_nchw, src_nchw, grid, 0, 1, True,
                                                        [False, True])

    return device_ms(torch, backward, "grid_sampler_2d_backward"), time_ms(backward)


def timed(torch, card, name, fn, plain, match, inputs, outputs, flops, err, lib=None,
          lib_name="grid_sample"):
    ms = device_ms(torch, fn, match)
    warm_ms = time_ms(fn)
    plain_ms = time_ms(plain)
    bms, by = bound_ms(inputs, outputs, flops)
    lib_ms, lib_warm = lib if lib is not None else (None, None)
    log("kernels", f"{name} at {tuple(outputs[0].shape)}: kernel {ms:.4f} ms (device, L2 flushed), "
        f"{warm_ms:.4f} ms (back to back, events); bound {bms:.4f} ms ({by}); plain "
        f"{plain_ms:.4f} ms"
        + (f"; {lib_name} {lib_ms:.4f} ms (device, L2 flushed), {lib_warm:.4f} ms (back "
           f"to back)" if lib_ms is not None else "; no library call computes it")
        + f" [{card}]")
    return dict(ms=ms, warm_ms=warm_ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                plain_ms=plain_ms, library_ms=lib_ms)


def phase_kernels(torch, wp, rp, cap: dict, card: str) -> dict:
    """Hold every kernel against its plain version on adversarial inputs and
    on the inputs the paths gave it, then time it on the latter."""
    dev = torch.device("cuda")
    k1a, k1b = cap["main"]["warp_static_fused"], cap["eval"]["warp_static"]
    k4 = cap["fused loss"]["warp_tall_taps"]
    k5, k5nt = cap["fused main"]["warp_tall_proj_taps"], cap["fused eval"]["warp_tall_proj_notaps"]
    k6, k6b = cap["fused main"]["reproj_err_fwd"], cap["fused loss"]["reproj_err_bwd"]
    k7 = cap["fused main"]["err_bwd_coords"]
    shapes = dict(K1a=k1a[0].shape, K1b=k1b[0].shape, K4=k4[1].shape, K5=k5[1].shape,
                  K5nt=k5nt[1].shape, K6=k6[0].shape, K6b=k6b[0].shape, K7=k7[0].shape)
    want = dict(K1a=(N_MAIN, H, W, C), K1b=(N_EVAL, H, W, C), K4=(N_MAIN, H, W, 2),
                K5=(S * 3, H, W, 1), K5nt=(S, H, W, 1), K6=(N_MAIN, H, W, C),
                K6b=(N_MAIN, H, W, C), K7=(N_MAIN, H, W, C))
    if {k: tuple(v) for k, v in shapes.items()} != want:
        raise AssertionError(f"kernel inputs of the paths: {shapes}")

    e1 = [check_k1(torch, wp, *warp_inputs(dev, N_MAIN), "adversarial coords"),
          check_k1(torch, wp, *warp_inputs(dev, N_EVAL), "adversarial coords"),
          check_k1(torch, wp, *k1a[:2], "the main path's inputs"),
          check_k1(torch, wp, *k1b[:2], "the eval path's inputs")]
    e4 = [check_tall(torch, wp, *warp_inputs(dev, N_MAIN, 6), "adversarial coords"),
          check_tall(torch, wp, *k4[:2], "the fused-loss path's inputs")]
    e5 = [check_proj(torch, wp, *proj_inputs(dev, 3), "adversarial depth"),
          check_proj(torch, wp, *proj_inputs(dev, 1), "adversarial depth"),
          check_proj(torch, wp, *k5[:3], "the fused main path's inputs"),
          check_proj(torch, wp, *k5nt[:3], "the fused eval path's inputs")]
    preds, target, gerr, (dx, dy) = err_inputs(dev, N_MAIN, 3)
    e6 = [check_err(torch, rp, preds, target, gerr, dx, dy, "adversarial preds"),
          check_err(torch, rp, *k7, "the fused main path's inputs"),
          check_err(torch, rp, *k6b, *k7[3:], "the fused-loss path's preds and g")]
    for name, args in (("fused eval", cap["fused eval"]["reproj_err_fwd"]),
                       ("fused loss", cap["fused loss"]["reproj_err_fwd"])):
        e, ep = rp.reproj_err_fwd(*args), rp.reproj_err_plain(*args)
        _require(rel_err(e, ep) <= 1e-5, f"K6 vs plain on the {name} path's inputs",
                 dict(rel=rel_err(e, ep)))
        log("kernels", f"K6 vs plain on the {name} path's inputs {tuple(args[0].shape)}: "
            f"rel {rel_err(e, ep):.3g}, max abs {max_abs(e, ep):.3g}")

    def worst(errs, keys):
        return max(e[k] for e in errs for k in keys)

    res = {}
    n_pix = N_MAIN * H * W
    for name, taps, bf16, (src, coords) in (
        ("warp_static_fused", True, True, k1a[:2]),
        ("warp_static_fused_f32", True, False, k1a[:2]),
        ("warp_static", False, True, k1b[:2]),
        ("warp_static_f32", False, False, k1b[:2]),
    ):
        fn = wp.warp_static_fused if taps else wp.warp_static
        plain = wp.warp_static_fused_plain if taps else wp.bilinear_sampler
        outs = fn(src, coords, bf16)
        outs = outs if taps else (outs,)
        key = ("taps" if taps else "notaps") + ("_bf16" if bf16 else "_f32")
        res[name] = timed(
            torch, card, name, lambda: fn(src, coords, bf16), lambda: plain(src, coords),
            "warp_kernel", (src, coords), outs,
            coords.shape[0] * H * W * ((10 + 22 * C) if taps else (10 + 9 * C)),
            worst(e1, [key]), None if taps else _grid_sample_ms(torch, src, coords))

    src2, coords, n_s, bf16 = k4
    outs = wp.warp_tall_taps(src2, coords, n_s, bf16)
    res["warp_tall"] = timed(
        torch, card, "warp_tall", lambda: wp.warp_tall_taps(src2, coords, n_s, bf16),
        lambda: wp.warp_tall_plain(src2, coords, n_s), "warp_kernel", (src2, coords), outs,
        n_pix * (10 + 22 * C), worst(e4, ["taps_bf16" if bf16 else "taps_f32"]))

    src2, depth, ab, n_s, bf16 = k5
    outs = wp.warp_tall_proj_taps(src2, depth, ab, n_s, bf16)
    res["warp_tall_proj"] = timed(
        torch, card, "warp_tall_proj",
        lambda: wp.warp_tall_proj_taps(src2, depth, ab, n_s, bf16),
        lambda: wp.warp_tall_proj_plain(src2, depth, ab, n_s), "warp_kernel",
        (src2, depth, ab), outs, n_pix * (30 + 22 * C),
        worst(e5, ["taps_bf16" if bf16 else "taps_f32"]))

    src2, depth, ab, n_s, bf16 = k5nt
    out = wp.warp_tall_proj_notaps(src2, depth, ab, n_s, bf16)
    coords = wp.proj_coords_plain(depth, ab, n_s)
    res["warp_tall_proj_notaps"] = timed(
        torch, card, "warp_tall_proj_notaps",
        lambda: wp.warp_tall_proj_notaps(src2, depth, ab, n_s, bf16),
        lambda: wp.bilinear_sampler(wp.tall_sources(src2, n_s), wp.proj_coords_plain(
            depth, ab, n_s)), "warp_kernel", (src2, depth, ab), (out,),
        out.shape[0] * H * W * (30 + 9 * C),
        worst(e5, ["notaps_bf16" if bf16 else "notaps_f32"]),
        _grid_sample_ms(torch, wp.tall_sources(src2, n_s), coords))

    preds, target = k6
    err = rp.reproj_err_fwd(preds, target)
    key = "bf16" if preds.dtype == torch.bfloat16 else "f32"
    res["reproj_err"] = timed(
        torch, card, "reproj_err", lambda: rp.reproj_err_fwd(preds, target),
        lambda: rp.reproj_err_plain(preds, target), "err_fwd_kernel", (preds, target), (err,),
        preds.numel() * ERR_FLOPS, worst(e6, [f"K6_{key}"]))

    preds, target, g = k6b
    dpred = rp.reproj_err_bwd(preds, target, g)
    key = "K6'_bf16" if preds.dtype == torch.bfloat16 else "K6'_f32"
    res["reproj_err_bwd"] = timed(
        torch, card, "reproj_err_bwd", lambda: rp.reproj_err_bwd(preds, target, g),
        lambda: rp.reproj_err_bwd_plain(preds, target, g).to(preds.dtype), "err_bwd_kernel",
        (preds, target, g), (dpred,), preds.numel() * ERR_BWD_FLOPS, worst(e6, [key]))

    preds, target, g, dx, dy = k7
    dc = rp.err_bwd_coords(preds, target, g, dx, dy)
    key = "K7_bf16" if preds.dtype == torch.bfloat16 else "K7_f32"
    res["err_bwd_coords"] = timed(
        torch, card, "err_bwd_coords", lambda: rp.err_bwd_coords(preds, target, g, dx, dy),
        lambda: rp.err_bwd_coords_plain(preds, target, g, dx, dy), "err_bwd_kernel",
        (preds, target, g, dx, dy), (dc,), preds.numel() * (ERR_BWD_FLOPS + 4),
        worst(e6, [key]))

    # K2 on the two-kernel paths (K3 and K3' are K2 with exact taps)
    k2, k2b = cap["two-kernel main"]["warp_static"], cap["two-kernel main"]["warp_static_bwd"]
    k2t, k2bt = cap["packed main"]["warp_static"], cap["packed main"]["warp_static_bwd"]
    k2e, k2p = cap["two-kernel eval"]["warp_static"], cap["predictor"]["warp_static_bwd"]
    shapes = [t[0].shape for t in (k2, k2b, k2t, k2bt, k2e, k2p, cap["seg-skip main"][
        "warp_static_bwd"])]
    flags = [k2[2:], k2b[3], k2t[2:], k2bt[3], k2e[2:]]
    if ([tuple(x) for x in shapes] != [(N_MAIN, H, W, C)] * 4 + [(N_EVAL, H, W, C)]
            + [(N_MAIN, H, W, C)] * 2
            or flags != [(False, False), False, (False, True), True, (False, False)]):
        raise AssertionError(f"two-kernel inputs of the paths: {shapes}, flags {flags}")
    gen = torch.Generator(device=dev).manual_seed(4)
    src_a, coords_a = warp_inputs(dev, N_MAIN)
    g_a = torch.randn(src_a.shape, generator=gen, device=dev)
    e2 = [check_k2(torch, wp, src_a, coords_a, g_a, "adversarial coords"),
          check_k2(torch, wp, *k2b[:3], "the two-kernel path's inputs"),
          check_k2(torch, wp, *k2bt[:3], "the packed path's inputs"),
          check_k2(torch, wp, *cap["seg-skip main"]["warp_static_bwd"][:3],
                   "the seg-skip path's inputs"),
          check_k2(torch, wp, *k2p[:3], "the predictor's inputs"),
          check_k2(torch, wp, *k2e[:2], torch.randn(k2e[0].shape, generator=gen, device=dev),
                   "the two-kernel eval path's inputs")]
    fwd_flops, bwd_flops = 10 + 9 * C, 14 + 16 * C
    for name, (src, coords, _, trunc) in (("warp_static_k2", k2), ("warp_static_k2_trunc", k2t)):
        out = wp.warp_static(src, coords, False, trunc)
        res[name] = timed(
            torch, card, name, lambda: wp.warp_static(src, coords, False, trunc),
            lambda: wp.warp_two_kernel_plain(src, coords, trunc), "warp_kernel", (src, coords),
            (out,), n_pix * fwd_flops, worst(e2, ["fwd_trunc" if trunc else "fwd_exact"]),
            _grid_sample_ms(torch, src, coords))
    for name, (src, coords, g, trunc) in (("warp_static_bwd", k2b), ("warp_static_bwd_trunc", k2bt)):
        d = wp.warp_static_bwd(src, coords, g, trunc)
        res[name] = timed(
            torch, card, name, lambda: wp.warp_static_bwd(src, coords, g, trunc),
            lambda: wp.warp_grad_plain(src, coords, g, trunc), "warp_grad_kernel",
            (src, coords, g), (d,), n_pix * bwd_flops,
            worst(e2, ["bwd_trunc" if trunc else "bwd_exact"]),
            _grid_sample_bwd_ms(torch, src, coords, g), "grid_sample backward")
    src, coords = k2e[:2]
    ms_eval = device_ms(torch, lambda: wp.warp_static(src, coords), "warp_kernel")
    bms_eval, _ = bound_ms((src, coords), (src,), src.shape[0] * H * W * fwd_flops)
    log("kernels", f"K2's forward on the two-kernel eval path's inputs "
        f"{tuple(src.shape)}: kernel {ms_eval:.4f} ms (device, L2 flushed); bound "
        f"{bms_eval:.4f} ms [{card}]")

    # K4 reads each of its 2*B sources once; K1 reads the S-fold tiled copy
    src2, coords, n_s, bf16 = k4
    tiled = wp.tall_sources(src2, n_s).contiguous()
    ms_tiled = device_ms(torch, lambda: wp.warp_static_fused(tiled, coords, bf16), "warp_kernel")
    log("kernels", f"on the fused-loss path's coords: K4 (2B = {src2.shape[0]} sources) "
        f"{res['warp_tall']['ms']:.4f} ms, K1 on the tiled sources {ms_tiled:.4f} ms "
        f"(device, L2 flushed) [{card}]")
    return res


def log_beside(phase: str, card: str, label: str, a, b) -> None:
    """Two paths' frame numbers from one call, side by side: each a
    (steady ms/frame, phase_profile result) pair."""
    (a_ms, a_prof), (b_ms, b_prof) = a, b
    if "busy_ms" in a_prof and "busy_ms" in b_prof:
        log(phase, f"{label}, same call: steady {a_ms:.2f} / {b_ms:.2f} ms/frame; profiled "
            f"wall {a_prof['wall_ms']:.2f} / {b_prof['wall_ms']:.2f} ms/frame; device busy "
            f"{a_prof['busy_ms']:.2f} / {b_prof['busy_ms']:.2f} ms/frame; idle share "
            f"{a_prof['idle']:.3f} / {b_prof['idle']:.3f}; device activities/frame "
            f"{a_prof['activities']:.0f} / {b_prof['activities']:.0f} [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpuslam_torch.ops import build
    from tpuslam_torch.ops import reproj as rp
    from tpuslam_torch.ops import warp as wp

    card = card_line()
    log("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 is "
        f"off inside the port's entry points")

    t0 = time.perf_counter()
    build.build_kernels()
    wp.load_library()
    rp.load_library()
    log("build", f"warp.cu and reproj.cu built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc, each started together: {build.build_seconds or 'cached'})")

    cap = {}  # path -> kernel wrapper -> its last inputs
    k1_taps = {"warp_static_fused": 5}
    two_kernel = {"warp_static": 5, "warp_static_bwd": 5}
    truncated = {"warp_static_trunc": 5, "warp_static_bwd_trunc": 5}
    fused_main = {"warp_tall_proj": 5, "reproj_err": 5, "err_bwd_coords": 5}
    fused_loss = {"warp_tall": 5, "reproj_err": 5, "reproj_err_bwd": 5}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log_dir = Path(tmp)
        k1_launches, slam, k1_ms = run_adapt_path(
            torch, wp, rp, "main", log_dir, cap.setdefault("main", {}), card, 12, k1_taps)
        k1_prof = phase_profile(torch, slam, card, "profile")
        del slam
        eval_launches = run_eval_path(torch, wp, rp, "eval", log_dir, cap.setdefault("eval", {}),
                                      {"warp_static": 2})
        two_launches, slam, two_ms = run_adapt_path(
            torch, wp, rp, "two-kernel main", log_dir, cap.setdefault("two-kernel main", {}),
            card, 12, two_kernel, pallas_fused_grad=False)
        two_prof = phase_profile(torch, slam, card, "two-kernel profile")
        del slam
        log_beside("two-kernel profile", card, "K1 path / two-kernel path",
                   (k1_ms, k1_prof), (two_ms, two_prof))
        run_eval_path(torch, wp, rp, "two-kernel eval", log_dir,
                      cap.setdefault("two-kernel eval", {}), {"warp_static": 2},
                      pallas_fused_grad=False)
        packed_launches, slam, _ = run_adapt_path(
            torch, wp, rp, "packed main", log_dir, cap.setdefault("packed main", {}), card, 4,
            truncated, pallas_packed=True)
        del slam
        _, slam, _ = run_adapt_path(
            torch, wp, rp, "seg-skip main", log_dir, cap.setdefault("seg-skip main", {}), card,
            2, truncated, pallas_seg_skip=True)
        del slam
        phase_predictor(torch, wp, rp, log_dir, cap.setdefault("predictor", {}), card)
        fused_launches, slam, fused_ms = run_adapt_path(
            torch, wp, rp, "fused main", log_dir, cap.setdefault("fused main", {}), card, 12,
            fused_main, **FUSED)
        fused_prof = phase_profile(torch, slam, card, "fused profile")
        del slam
        log_beside("fused profile", card, "K1 path / fused stack", (k1_ms, k1_prof),
                   (fused_ms, fused_prof))
        fused_eval_launches = run_eval_path(
            torch, wp, rp, "fused eval", log_dir, cap.setdefault("fused eval", {}),
            {"warp_tall_proj_notaps": 2, "reproj_err": 2}, **FUSED)
        fused_loss_launches, slam, _ = run_adapt_path(
            torch, wp, rp, "fused loss", log_dir, cap.setdefault("fused loss", {}), card, 4,
            fused_loss, pallas_tall=True, pallas_fused_loss=True)
        del slam
        results = phase_kernels(torch, wp, rp, cap, card)
        cap.clear()
        phase_reference(torch, log_dir, "K1 path")
        phase_reference(torch, log_dir, "fused stack", **FUSED)
        # the K1 path at the two-kernel routes' size tells the size's share
        # of their card-vs-CPU difference from the route's
        phase_reference(torch, log_dir, "K1 path", 64, 384)
        phase_reference(torch, log_dir, "two-kernel path", 64, 384, pallas_fused_grad=False)
        phase_reference(torch, log_dir, "packed", 64, 384, pallas_packed=True)

    warp_src, err_src = "tpuslam_torch/csrc/warp.cu", "tpuslam_torch/csrc/reproj.cu"
    # (name, source, TPU kernel, launches on its path, counter, timing):
    # K1b and K2's forward are one launch without taps, one counter; K3 and
    # K3' are K2 with exact taps (no path calls pallas_warp), so their rows
    # carry K2's launches and times
    kernels = [
        ("warp_static_fused", warp_src, "tpuslam/ops/pallas_warp.py:1244", k1_launches,
         "warp_static_fused", "warp_static_fused"),
        ("warp_static", warp_src, "tpuslam/ops/pallas_warp.py:745", eval_launches,
         "warp_static", "warp_static"),
        ("warp_static_k2", warp_src, "tpuslam/ops/pallas_warp.py:745", two_launches,
         "warp_static", "warp_static_k2"),
        ("warp_static_k2_trunc", warp_src, "tpuslam/ops/pallas_warp.py:745", packed_launches,
         "warp_static_trunc", "warp_static_k2_trunc"),
        ("warp_static_bwd", warp_src, "tpuslam/ops/pallas_warp.py:805", two_launches,
         "warp_static_bwd", "warp_static_bwd"),
        ("warp_static_bwd_trunc", warp_src, "tpuslam/ops/pallas_warp.py:805", packed_launches,
         "warp_static_bwd_trunc", "warp_static_bwd_trunc"),
        ("warp_dynamic", warp_src, "tpuslam/ops/pallas_warp.py:172", two_launches,
         "warp_static", "warp_static_k2"),
        ("warp_dynamic_bwd", warp_src, "tpuslam/ops/pallas_warp.py:205", two_launches,
         "warp_static_bwd", "warp_static_bwd"),
        ("warp_tall", warp_src, "tpuslam/ops/pallas_warp.py:955", fused_loss_launches,
         "warp_tall", "warp_tall"),
        ("warp_tall_proj", warp_src, "tpuslam/ops/pallas_warp.py:1135", fused_launches,
         "warp_tall_proj", "warp_tall_proj"),
        ("warp_tall_proj_notaps", warp_src, "tpuslam/ops/pallas_warp.py:1135",
         fused_eval_launches, "warp_tall_proj_notaps", "warp_tall_proj_notaps"),
        ("reproj_err", err_src, "tpuslam/ops/pallas_loss.py:226", fused_launches,
         "reproj_err", "reproj_err"),
        ("reproj_err_bwd", err_src, "tpuslam/ops/pallas_loss.py:261", fused_loss_launches,
         "reproj_err_bwd", "reproj_err_bwd"),
        ("err_bwd_coords", err_src, "tpuslam/ops/pallas_fused.py:118", fused_launches,
         "err_bwd_coords", "err_bwd_coords"),
    ]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = [dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches[counter], **{k: results[timing][k] for k in keys})
            for name, source, replaces, launches, counter, timing in kernels]
    print(json.dumps({"kernels": line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
