#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tpuslam_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing lines tagged with its name and raising on failure
(exit code != 0):

1. device: the card's name and power limit;
2. build: both kernel libraries (tpuslam_torch/csrc/warp.cu, reproj.cu),
   one nvcc each, started together, then the C++ pose-graph solver
   (native/posegraph.cc, g++);
3. main: eight frames of `Slam.step` with online adaptation on the
   synthetic world at 192 x 640, ResNet-18 depth and pose, batch 3, K = 5,
   the shipped `pallas_*` defaults: K1 runs with taps on N = 2*S*B = 24
   images;
4. profile: three more frames under torch.profiler give the host / device
   split of a frame; then cli adapt: `Slam.save_model` of that Slam, and
   `tpuslam_torch.cli.adapt` on a YAML with `adapt_kitti.yaml`'s settings
   (`Dataset: Synthetic`, 12 frames, `load_weights_folder` that checkpoint,
   `plot_frequency` at its default): the reload bit for bit, the CLI's
   output files and 5 K1a launches per frame;
5. eval: two frames with `adaptation: false` (batch 1): K1 without taps on
   N = 2*S = 8 images;
6. two-kernel main: eight adapted frames with `pallas_fused_grad: false`:
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
14. lc main: `Slam.run` over 40 frames of the synthetic loop at the
    operating point of `adapt_kitti.yaml`: adaptation on the K1 path, loop
    closure on the depth-encoder embedding, `pipeline_depth: 3`, a prefetch
    of 3 frames (`id_threshold` and `detection_threshold` lowered so that a
    loop edge fires on random weights): 5 K1a launches per frame and no
    other kernel, at least one loop edge solved by the C++ solver; the graph
    as it stood before that solve, and a 1,000-vertex chain, solved by the
    float64 LM on the card and on the CPU and by the C++ solver, which must
    agree;
15. lc mobilenet: the same `Slam.run` over 30 frames of the loop with
    loop closure on the MobileNetV3-small embedder (`embedder: mobilenet`,
    random weights): 5 K1a launches and one embedder forward per frame, at
    least one loop edge, its steady ms/frame beside lc main's and the
    embedder's own (CUDA events), and the card's embeddings of 4 frames
    against the CPU port's;
16. rungs: `tpuslam_torch.cli.rungs` at 192 x 640, 16 frames, all five
    rungs and rung 5's sync ablation, with the launches read around each
    rung (K1b once a frame in rung 1 and in the async rung 5, whose updates
    launch K1a 3 times each on a second CUDA stream; K1a 3 times a frame
    elsewhere, plus once per generalist consolidation in rung 3), the
    async rung's launched / adopted updates and each rung's steady
    ms/frame;
17. async check: the CoVIO update on the side stream against the same
    update on the current stream (K = 1: 1e-5 relative; K = 5 logged beside
    two runs on one stream), the serving state unchanged bit for bit, and a
    serving `eval_step` issued before the update's event is waited on equal
    to one issued after it;
18. pretrain: `Pretrainer` at 192 x 640, ResNet-18, batch 18, on the K1a
    route (`pallas_warp=True`) and on the plain sampler: an epoch of 5
    `train_step`s (the whole network, batch norm in train mode) and a
    `validate` over 2 batches (5 K1a launches on N = 2*S*B = 144 images and
    2 K1b; none on the plain route), then the steady ms/step of 5 more
    steps, 3 steps under torch.profiler and the peak memory of each route;
19. cli pretrain: `tpuslam_torch.cli.pretrain` on
    `pretrain_collapse_synthetic_192.yaml` for 2 epochs (12 of its 64
    frames), with no kernel launch (it runs the plain sampler), its
    `weights_*` folders and models/best.yaml, then one more epoch resumed
    through `Pretrainer.load`;
20. ddp: a data-parallel pretraining step (`tpuslam_torch.parallel`, sync-BN)
    at 192 x 640, batch 18, world size 1 over NCCL and 2 ranks over gloo on
    the one card, each held against the single-process `train_step` on the
    whole batch, with their ms/step;
21. profiling: `profile_adapt_step` (K = 1, 5, 10) and `calibrate` at
    192 x 640, batch 3 (no class may read faster than 95% of its speed of
    light on the H100), `frame_sol_ms`, and a Chrome trace of one
    `adapt_step` through `utils.profiling.trace`;
22. kernels: every kernel (K1 with and without taps, K2's forward and
    backward with exact and truncated taps, K3 and K3', K4, K5 with and
    without taps, K6, K6', K7/K8) held against its plain torch version on
    adversarial inputs and on the inputs the paths gave it (the error-map
    kernels also with ties and clamped SSIM across their tile boundaries,
    at shapes no tile divides, at H = 2, at W = 2 and at C = 4; the warps
    at shapes no run of columns or 16-byte vector divides, at H = 2, W = 2,
    C = 4 and C = 1, and with coordinates and depth at an odd element
    offset), then timed
    on the latter beside the plain version, the bound and, for the warps
    without taps (K2's forward on the eval path too) and the backward
    gathers, torch's grid_sample forward and backward (K3 and K3' are K2
    with exact taps, `warp_dynamic`: no path calls them, and their rows
    carry K2's numbers); K1a and K1b also on the pretrain path's inputs,
    each a row of its own;
23. reference: one adaptation step on the card and on the CPU at a small
    size, with the K1 path, the fused stack, the two-kernel path and the
    packed variant (and the K1 path again at their size), and one
    `train_step` on the K1a route and on the plain one, which must agree.

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
    # the trace may miss the first launches after it starts (up to 11 of
    # them seen on the H100), and now and then it holds none of them (seen
    # once, for grid_sample): take a fresh one, at most three
    warm = 30
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


def err_inputs(device, n: int, B: int, h: int = H, w: int = W, c: int = C):
    """preds (n, h, w, c), targets (B, h, w, c), error cotangent g and tap
    differentials, with: a region where pred equals its target exactly
    (|y - x| = 0) touching rows and columns 0 and 1; another touching rows
    and columns h-2, h-1 and w-2, w-1; constant equal patches (SSIM = 1 on
    the clamp's edge); and patches where pred is target scaled by 1 + 2^-20,
    where rounding puts SSIM above 1 and the clamp is active.  A second set
    of tie, constant and clamp-active patches straddles the kernels' interior
    tile boundaries (rows 16, 32 and 48, columns 64, 128 and 192).  Patches
    past a small shape's edge are cut by the slicing."""
    import torch

    g = torch.Generator(device=device).manual_seed(n + 100 + h + w)
    target = torch.rand((B, h, w, c), generator=g, device=device)
    preds = torch.rand((n, h, w, c), generator=g, device=device)
    preds[0, :40, :100] = target[0, :40, :100]
    preds[1 % n, -30:, -50:] = target[1 % B, -30:, -50:]
    target[0, 60:90, 200:260] = 0.5
    preds[0, 60:90, 200:260] = 0.5
    preds[0, 100:130, 300:400] = target[0, 100:130, 300:400] * (1 + 2.0 ** -20)
    k = 2 % n
    preds[k, 12:21, 58:71] = target[k % B, 12:21, 58:71]  # ties across row 16, column 64
    target[k % B, 27:38, 122:135] = 0.25  # constant and equal across row 32, column 128
    preds[k, 27:38, 122:135] = 0.25
    preds[k, 42:55, 184:201] = target[k % B, 42:55, 184:201] * (1 + 2.0 ** -20)  # clamp
    gerr = torch.randn((n, h, w), generator=g, device=device)
    taps = [torch.randn((n, h, w, c), generator=g, device=device) for _ in range(2)]
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


def check_warp_edges(torch, wp, dev) -> dict:
    """The forward warp kernel where its design can go wrong: shapes that no
    run of columns or 16-byte vector divides (ragged runs, unaligned heads
    and tails of the output spans), H = 2, W = 2, C = 4 and C = 1; and
    coordinates at an odd element offset, which the kernel reads as two
    floats a pixel instead of one float2 (K5's depth, read a float at a time
    on every path, sits at an odd offset too).  Only the forward launches
    see the unaligned views: the autograd halves of the checks run on
    aligned clones.  K1, K2, K4 and K5 at the tolerances of their checks;
    returns their errors by kernel."""
    from tpuslam_torch.tools.warp_ab import odd_offset, proj_inputs, warp_inputs

    gen = torch.Generator(device=dev).manual_seed(5)
    errs = {"K1": [], "K2": [], "K4": [], "K5": []}
    for n, shape, odd in ((6, (50, 130, 3), False), (6, (50, 130, 3), True),
                          (4, (2, 70, 3), False), (3, (37, 2, 3), False),
                          (2, (40, 70, 4), False), (2, (40, 70, 1), False)):
        tag = "coords and depth at an odd offset" if odd else "a ragged shape"
        place = odd_offset if odd else (lambda t: t)
        src, coords = warp_inputs(dev, n, shape=shape)
        coords = place(coords)
        errs["K1"].append(check_k1(torch, wp, src, coords, tag))
        g = torch.randn(src.shape, generator=gen, device=dev)
        errs["K2"].append(check_k2(torch, wp, src, coords, g, tag))
        src2, coords = warp_inputs(dev, 2 * n, 2, shape)
        errs["K4"].append(check_tall(torch, wp, src2, place(coords), tag))
        src2, depth, ab = proj_inputs(dev, 1, shape)
        errs["K5"].append(check_proj(torch, wp, src2, place(depth), ab, tag))
    return errs


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


LC_FRAMES = 40  # frames of the "lc main" path, the synthetic loop's length


def chain_graph(n: int, seed: int, loops):
    """A noisy chain of n poses 0.5 m apart with loop edges of information
    2 I, built as `tests/test_posegraph.py::test_solver_scaling_1k_vertices`
    builds it; returns (graph, ground-truth poses)."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from tpuslam_torch.posegraph.graph import PoseGraph

    def se3(rotvec, t):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
        T[:3, 3] = t
        return T

    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for _ in range(n - 1):
        gt.append(gt[-1] @ se3(rng.normal(scale=0.03, size=3), [0, 0, 0.5]))
    g = PoseGraph()
    est = gt[0]
    g.add_vertex(0, est, fixed=True)
    for i in range(1, n):
        Z = np.linalg.inv(gt[i - 1]) @ gt[i] @ se3(rng.normal(scale=0.05 * 0.05, size=3),
                                                    rng.normal(scale=0.05, size=3))
        est = est @ Z
        g.add_vertex(i, est)
        g.add_edge((i - 1, i), Z)
    for i, j in loops:
        g.add_edge((i, j), np.linalg.inv(gt[i]) @ gt[j], information=np.eye(6) * 2.0,
                   is_loop_closure=True)
    return g, gt


def solve_three_ways(graph, gt, tag: str, card: str, turns: int) -> dict:
    """Copies of `graph` solved by the float64 LM on the card and on the CPU
    and by the C++ solver (cap 10000, as `Slam` asks), `turns` times each;
    logs each backend's error, ATE against `gt` and wall times (host clock
    around the solve, which ends in a host read).  Returns backend ->
    (poses, error)."""
    import copy

    import numpy as np

    from tpuslam_torch.eval.trajectory import compute_ate

    out = {}
    ate0 = compute_ate(graph.get_all_poses(), gt)
    for name, backend, device in (("torch card", "torch", "cuda"), ("torch CPU", "torch", "cpu"),
                                  ("native", "native", "cpu")):
        seconds = []
        for _ in range(turns):
            g = copy.deepcopy(graph)
            t0 = time.perf_counter()
            err = g.optimize(max_iterations=10000, backend=backend, device=device)
            seconds.append(time.perf_counter() - t0)
            if g.last_backend != backend:
                raise AssertionError(f"{tag}: asked for {backend}, solved with {g.last_backend}")
        poses = g.get_all_poses()
        out[name] = (np.stack(poses), err)
        log("lc main", f"{tag}, {name}: error {err:.9g}, ATE {ate0:.4f} -> "
            f"{compute_ate(poses, gt):.4f} m, solve "
            + " / ".join(f"{1e3 * t:.1f}" for t in seconds) + f" ms (turns) [{card}]")
    return out


def check_solves(solves: dict, tag: str, strict: bool) -> None:
    """Each pair of solves agrees within `test_native_solver_matches_jax`'s
    tolerances: error no more than 1.5x the other's + 1e-6, ATE between
    them < 0.15 m.  With `strict` also: the card's and the CPU's torch
    solves (float64, another order of summation) within 1e-9 relative in
    error and 1e-6 in poses, and torch against the C++ solver within 1e-6
    relative in error."""
    import itertools

    import numpy as np

    err = {}
    for (a, (pa, ea)), (b, (pb, eb)) in itertools.combinations(solves.items(), 2):
        key = f"{a} / {b}".replace(" ", "_")
        err[f"{key}_err_rel"] = abs(ea - eb) / eb
        err[f"{key}_ate"] = float(np.sqrt(np.mean(np.sum((pa - pb)[:, :3, 3] ** 2, -1))))
        err[f"{key}_poses"] = float(np.abs(pa - pb).max())
        ok = ea <= 1.5 * eb + 1e-6 and eb <= 1.5 * ea + 1e-6 and err[f"{key}_ate"] < 0.15
        _require(ok, f"lc main: the {a} and {b} solves of {tag} disagree", err)
    if strict:
        card_cpu, card_native = "torch_card_/_torch_CPU", "torch_card_/_native"
        _require(err[f"{card_cpu}_err_rel"] <= 1e-9 and err[f"{card_cpu}_poses"] <= 1e-6
                 and err[f"{card_native}_err_rel"] <= 1e-6,
                 f"lc main: the solves of {tag} disagree", err)
    log("lc main", f"{tag}: solves agree: " + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))


def phase_lc_main(torch, wp, rp, log_dir: Path, captured: dict, card: str, k1_ms) -> float:
    """`Slam.run` over the synthetic loop at the operating point of
    `adapt_kitti.yaml`: adaptation (batch 3, K = 5, the shipped `pallas_*`
    defaults, bf16 networks), loop closure on the depth-encoder embedding
    (`keyframe_frequency: 5`, `lc_distance_poses: 150`), `pipeline_depth: 3`
    and a prefetch of 3 frames.  Reduced: 40 frames, random weights,
    `id_threshold` 250 -> 20 and `detection_threshold` 0.99 -> 0.5 (every
    similarity of random weights lies above it), so that a loop edge fires.
    Checks the losses, one vertex per adapted frame after the flush, at
    least one loop edge solved by the C++ solver, 5 K1a launches per
    adapted frame and no other kernel, and an empty retire queue; then
    solves the graph as it stood before its first solve, and a 1,000-vertex
    chain, on the card, on the CPU and in C++, and holds them together.
    Returns the steady ms/frame."""
    import copy
    import math

    import numpy as np

    from tpuslam_torch.eval.trajectory import compute_ate
    from tpuslam_torch.slam import Slam

    cfg = smoke_config(log_dir, adaptation=True)
    cfg.dataset.num_frames, cfg.dataset.trajectory = LC_FRAMES, "loop"
    cfg.slam.do_loop_closures, cfg.slam.pipeline_depth = True, 3
    cfg.slam.keyframe_frequency, cfg.slam.lc_distance_poses = 5, 150
    cfg.loop_closure.embedder = "depth_encoder"
    cfg.loop_closure.id_threshold, cfg.loop_closure.detection_threshold = 20, 0.5
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    slam = Slam(cfg, device="cuda")

    searches, snapshots, runs = [], [], []
    search = slam.loop_closure_detection.search

    def logged_search(frame_id):
        det = slam.loop_closure_detection
        sims, ids = det.index.search(det.index.reconstruct(frame_id)[None],
                                     min(100, det.index.ntotal))
        ok = (ids[0] >= 0) & (np.abs(ids[0] - frame_id) > det.id_threshold)
        searches.append((frame_id, ids[0][ok], sims[0][ok]))
        return search(frame_id)

    optimize = slam.pose_graph.optimize

    def kept_optimize(**kwargs):
        if not snapshots:  # the graph as it stands before its first solve
            snapshot = copy.deepcopy(slam.pose_graph)
            del vars(snapshot)["optimize"]  # this wrapper, copied with the instance
            snapshots.append(snapshot)
        t0 = time.perf_counter()
        err = optimize(**kwargs)
        runs.append((kwargs, slam.pose_graph.last_backend, err, time.perf_counter() - t0))
        return err

    slam.loop_closure_detection.search = logged_search
    slam.pose_graph.optimize = kept_optimize
    reset_launches(wp, rp)
    t0 = time.perf_counter()
    with PathGuard(wp, rp, captured):
        slam.run(max_steps=LC_FRAMES, progress=False, prefetch_depth=3)
    run_s = time.perf_counter() - t0
    launches = read_launches(wp, rp)
    adapted = len(slam.step_times)
    if slam._retire_queue or adapted != LC_FRAMES:
        raise AssertionError(f"lc main: {len(slam._retire_queue)} frames left in the retire "
                             f"queue, {adapted} of {LC_FRAMES} frames adapted")
    losses = slam.depth_loss + slam.velocity_loss
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"lc main: non-finite losses {losses}")
    if slam.pose_graph.vertex_ids != list(range(adapted + 1)):
        raise AssertionError(f"lc main: pose graph vertices {slam.pose_graph.vertex_ids}")
    expect_launches("lc main", launches, {"warp_static_fused": 5 * adapted})
    if slam.pose_graph.num_loop_closures < 1 or not runs:
        raise AssertionError(f"lc main: {slam.pose_graph.num_loop_closures} loop edges, "
                             f"{len(runs)} solves; searches {searches}")
    before = snapshots[0]
    if any(backend != "native" or kw.get("backend") != "auto" for kw, backend, _, _ in runs):
        raise AssertionError(f"lc main: solves {runs}")
    ms = 1e3 * float(np.mean(slam.step_times[2:]))
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    for frame_id, ids, sims in searches:
        log("lc main", f"search at frame {frame_id}: candidates "
            + (", ".join(f"{i} sim {s:.6f}" for i, s in zip(ids, sims)) or "none")
            + " (threshold 0.5, id_threshold 20)")
    for d in slam.lc_edge_diagnostics:
        log("lc main", f"loop edge {d['step']} -> {d['lc_id']}: sim {d['sim']:.6f}, predicted "
            f"distance {d['pred_dist']:.3f} m, ground truth {d['gt_dist']:.3f} m")
    gt = slam.gt_pose_graph.get_all_poses()
    ate_before = compute_ate(before.get_all_poses(), gt[:len(before)])
    ate_line = [l for l in slam.final_report().splitlines() if "Abs traj RMSE" in l]
    log("lc main", f"{adapted} frames adapted in Slam.run, loss {slam.depth_loss[-1]:.5f} "
        f"(depth), launches { {k: v for k, v in launches.items() if v} }, "
        f"{slam.pose_graph.num_loop_closures} loop edge(s), solves "
        + ", ".join(f"{b} {1e3 * t:.1f} ms (error {e:.6g})" for _, b, e, t in runs)
        + f"; ATE of the {len(before)} vertices before the first solve {ate_before:.4f} m; "
        f"final report {ate_line}; steady {ms:.2f} ms/frame = {1e3 / ms:.2f} frames/s "
        f"(frames 3-{adapted}; the K1 path's Slam.step loop: {k1_ms:.2f} ms/frame), run "
        f"{run_s:.2f} s; peak memory {peak:.2f} GiB above the {held / 2**30:.2f} GiB held "
        f"before the path [{card}]")

    check_solves(solve_three_ways(before, gt[:len(before)], f"the path's graph before its "
                                  f"first solve ({len(before)} vertices, "
                                  f"{before.num_loop_closures} loop edge(s))", card, 2),
                 "the path's graph", strict=True)
    chain, chain_gt = chain_graph(1000, 42, [(0, 999), (100, 900), (250, 750)])
    check_solves(solve_three_ways(chain, chain_gt, "a 1,000-vertex chain (3 loop edges)", card, 1),
                 "the 1,000-vertex chain", strict=False)
    return ms


LC_MOBILENET_FRAMES = 30  # the synthetic loop cut to 30 frames: one search (frame 25) past id_threshold


def phase_lc_mobilenet(torch, wp, rp, log_dir: Path, card: str, lc_ms: float) -> None:
    """`Slam.run` as in "lc main" (adaptation on the K1 path, `pipeline_depth:
    3`, a prefetch of 3 frames, `id_threshold` 20, `detection_threshold`
    0.5), with loop closure on the MobileNetV3-small embedder (`embedder:
    mobilenet`, randomly initialised: the repository holds no ImageNet
    weights) over 30 frames of the synthetic loop.  Checks the losses, one
    vertex per frame, at least one loop edge, 5 K1a launches per frame and
    no other kernel, one embedder forward per frame; logs the searches and
    edges, the steady ms/frame beside "lc main"'s and the embedder's own
    ms/frame (CUDA events around each call); then holds the card's
    embeddings of 4 frames against the CPU port's within 1e-4 relative."""
    import copy

    import numpy as np

    from tpuslam_torch.slam import Slam

    cfg = smoke_config(log_dir, adaptation=True)
    cfg.dataset.num_frames, cfg.dataset.trajectory = LC_MOBILENET_FRAMES, "loop"
    cfg.slam.do_loop_closures, cfg.slam.pipeline_depth = True, 3
    cfg.slam.keyframe_frequency, cfg.slam.lc_distance_poses = 5, 150
    cfg.loop_closure.embedder = "mobilenet"
    cfg.loop_closure.id_threshold, cfg.loop_closure.detection_threshold = 20, 0.5
    slam = Slam(cfg, device="cuda")
    embedder = slam._mobilenet
    spans, searches = [], []
    embed = embedder.embed

    def timed_embed(images):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = embed(images)
        end.record()
        spans.append((start, end))
        return out

    search = slam.loop_closure_detection.search

    def logged_search(frame_id):
        det = slam.loop_closure_detection
        sims, ids = det.index.search(det.index.reconstruct(frame_id)[None],
                                     min(100, det.index.ntotal))
        ok = (ids[0] >= 0) & (np.abs(ids[0] - frame_id) > det.id_threshold)
        searches.append((frame_id, ids[0][ok], sims[0][ok]))
        return search(frame_id)

    embedder.embed = timed_embed
    slam.loop_closure_detection.search = logged_search
    reset_launches(wp, rp)
    with PathGuard(wp, rp, {}):
        slam.run(max_steps=LC_MOBILENET_FRAMES, progress=False, prefetch_depth=3)
    launches = read_launches(wp, rp)
    del embedder.embed  # the class's method again
    torch.cuda.synchronize()
    adapted = len(slam.step_times)
    losses = slam.depth_loss + slam.velocity_loss
    if slam._retire_queue or adapted != LC_MOBILENET_FRAMES or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"lc mobilenet: {adapted} frames adapted, queue "
                             f"{len(slam._retire_queue)}, losses {losses}")
    if slam.pose_graph.vertex_ids != list(range(adapted + 1)) or len(spans) != adapted:
        raise AssertionError(f"lc mobilenet: vertices {slam.pose_graph.vertex_ids}, "
                             f"{len(spans)} embedder calls")
    expect_launches("lc mobilenet", launches, {"warp_static_fused": 5 * adapted})
    if slam.pose_graph.num_loop_closures < 1:
        raise AssertionError(f"lc mobilenet: no loop edge; searches {searches}")
    for frame_id, ids, sims in searches:
        log("lc mobilenet", f"search at frame {frame_id}: candidates "
            + (", ".join(f"{i} sim {s:.6f}" for i, s in zip(ids, sims)) or "none")
            + " (threshold 0.5, id_threshold 20)")
    for d in slam.lc_edge_diagnostics:
        log("lc mobilenet", f"loop edge {d['step']} -> {d['lc_id']}: sim {d['sim']:.6f}, "
            f"predicted distance {d['pred_dist']:.3f} m, ground truth {d['gt_dist']:.3f} m")
    ms = 1e3 * float(np.mean(slam.step_times[2:]))
    embed_ms = float(np.mean([s.elapsed_time(e) for s, e in spans[2:]]))
    log("lc mobilenet", f"{adapted} frames adapted in Slam.run, launches "
        f"{ {k: v for k, v in launches.items() if v} }, {slam.pose_graph.num_loop_closures} "
        f"loop edge(s), index of {slam.loop_closure_detection.index.ntotal} 576-d embeddings; "
        f"steady {ms:.2f} ms/frame (frames 3-{adapted}) beside lc main's {lc_ms:.2f}; the "
        f"embedder {embed_ms:.3f} ms/frame between CUDA events (frames 3-{adapted}) [{card}]")

    images = np.stack([slam.dataset[i].rgb[2] for i in (0, 7, 14, 21)])
    got = embedder.embed(torch.from_numpy(images).cuda()).cpu()
    want = copy.deepcopy(embedder).cpu().embed(torch.from_numpy(images))
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    if not max(errs) <= 1e-4:
        raise AssertionError(f"lc mobilenet: card vs CPU embeddings {errs}")
    log("lc mobilenet", "card vs CPU embeddings of frames 1, 8, 15, 22: relative "
        + ", ".join(f"{e:.3g}" for e in errs) + " (limit 1e-4)")


DDP_STEPS = 3  # timed data-parallel steps after the one compared
# Relative distance from the float64 `train_step` allowed to each float32
# step of phase "ddp" (gradients network by network, as one vector each).
# Sound steps read (NVIDIA H100 80GB HBM3, 700 W): losses <= 1.33e-6, BN
# statistics <= 3.81e-8, decoders <= 3.81e-4, depth encoder <= 1.36e-3, pose
# encoder <= 4.83e-3; the phase's control, the two ranks without sync-BN,
# must land outside them (PERF.md, PR 9).
DDP_LIMITS = {"losses": 1e-5, "stats": 1e-5, "depth_decoder": 1e-3, "pose_decoder": 1e-3,
              "depth_encoder": 5e-3, "pose_encoder": 1.5e-2}


def ddp_config():
    from tpuslam_torch.train.steps import LossConfig

    # the Pretrainer's defaults: four scales, the plain sampler, float32 networks
    return LossConfig(scales=(0, 1, 2, 3), use_pallas_warp=False, bf16_networks=False)


def ddp_model(torch, dtype=None):
    from tpuslam_torch.models.depth_pose import init_depth_pose

    model = init_depth_pose(0, device="cuda")
    model.requires_grad_(True)
    return model if dtype is None else model.to(dtype)


def ddp_snapshot(torch, state, losses, step_fn, steps=DDP_STEPS):
    """One step's losses, each network's gradient as one vector and the BN
    running statistics as one, then `steps` more steps timed (host clock,
    ended by a synchronize)."""
    import numpy as np

    model = state.model
    grads = {}
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        grads.setdefault(k.split(".")[0], []).append(g.double().cpu().numpy().ravel())
    out = {f"grad/{n}": np.concatenate(v) for n, v in grads.items()}
    out["losses"] = np.array([float(losses[k]) for k in sorted(losses)])
    out["stats"] = np.concatenate([v.double().cpu().numpy().ravel()
                                   for k, v in model.state_dict().items() if "running" in k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step_fn()
    torch.cuda.synchronize()
    out["ms"] = np.array(1e3 * (time.perf_counter() - t0) / max(steps, 1))
    return out


def ddp_run(torch, rank: int, world: int, tmp: Path, steps=DDP_STEPS):
    """This rank's data-parallel step on its slice of the phase's batch."""
    import numpy as np

    from tpuslam_torch.parallel import make_dp_train_step, shard_batch
    from tpuslam_torch.train.batch import make_frame_batch
    from tpuslam_torch.train.state import make_pretrain_optimizer, make_train_state

    arrays = dict(np.load(tmp / "ddp_batch.npz"))
    shard = shard_batch(make_frame_batch(**arrays, device="cuda"), rank, world)
    model = ddp_model(torch)
    state = make_train_state(model, make_pretrain_optimizer(model, 1e-4), seed=None)
    step = make_dp_train_step(model, ddp_config())
    losses = step(state, shard)
    return ddp_snapshot(torch, state, losses, lambda: step(state, shard), steps)


def ddp_gloo_rank(rank: int, init_method: str, tmp: str) -> None:
    """One of two ranks of phase "ddp", over gloo on the one card; then the
    phase's control, one step with each rank's batch norms on its own
    half of the batch (sync-BN off)."""
    import contextlib

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from tpuslam_torch.parallel import make_process_group, mesh

    make_process_group(2, rank, "cuda:0", init_method, backend="gloo")
    try:
        out = ddp_run(torch, rank, 2, Path(tmp))
        mesh.sync_batch_norm = lambda model, group: contextlib.nullcontext()
        control = ddp_run(torch, rank, 2, Path(tmp), steps=0)
        if rank == 0:
            np.savez(Path(tmp) / "ddp_gloo.npz", **out)
            np.savez(Path(tmp) / "ddp_control.npz", **control)
    finally:
        dist.destroy_process_group()


def phase_ddp(torch, wp, rp, log_dir: Path, card: str) -> None:
    """A data-parallel pretraining step (`tpuslam_torch.parallel`: sync-BN,
    averaged gradients and losses) at 192 x 640, ResNet-18, batch 18, the
    Pretrainer's route (plain sampler, float32 networks, noise off), in two
    setups: world size 1 over NCCL in this process, and 2 ranks over gloo
    sharing the one card (NCCL refuses two ranks on one device), started
    with torch.multiprocessing.  The single-process `train_step` on the
    whole batch runs beside them in float32 and, as their common oracle, in
    float64 (the card's float32 gradients at this size are ill-conditioned:
    PERF.md).  Each float32 step, the single-process one included, must
    hold its losses, its BN running statistics and each network's gradient
    (one vector each) within `DDP_LIMITS` of float64 (relative); the
    control, the two ranks without sync-BN, must break at least one of
    them.  Logs everything beside everything, and each one's ms/step; no
    kernel launches (plain sampler)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from tpuslam_torch.data.synthetic import SyntheticDataset
    from tpuslam_torch.parallel import local_init_method, make_process_group
    from tpuslam_torch.train.batch import make_frame_batch
    from tpuslam_torch.train.pretrain import stack_samples
    from tpuslam_torch.train.state import make_pretrain_optimizer, make_train_state
    from tpuslam_torch.train.steps import train_step

    world_ds = SyntheticDataset(num_frames=PRETRAIN_B + 2, height=H, width=W,
                                do_augmentation=True)
    arrays = stack_samples([world_ds[i] for i in range(PRETRAIN_B)])
    del arrays["mask"]
    np.savez(log_dir / "ddp_batch.npz", **arrays)
    reset_launches(wp, rp)
    runs = {}
    for name, dtype in (("train_step float64", torch.float64), ("train_step", None)):
        model = ddp_model(torch, dtype)
        state = make_train_state(model, make_pretrain_optimizer(model, 1e-4), seed=None)
        batch = make_frame_batch(**arrays, device="cuda")
        if dtype is not None:
            floats = {f.name: getattr(batch, f.name).to(dtype)
                      for f in dataclasses.fields(batch) if f.name not in ("rgb", "rgb_aug")
                      and getattr(batch, f.name) is not None}
            batch = dataclasses.replace(batch, rgb=batch.rgb.to(dtype) / 255,
                                        rgb_aug=batch.rgb_aug.to(dtype) / 255, **floats)
        losses = train_step(state, ddp_config(), batch)
        runs[name] = ddp_snapshot(torch, state, losses,
                                  lambda: train_step(state, ddp_config(), batch))
        del model, state, batch, losses
        torch.cuda.empty_cache()

    make_process_group(1, 0, "cuda", local_init_method())
    try:
        runs["world size 1 over NCCL"] = ddp_run(torch, 0, 1, log_dir)
    finally:
        dist.destroy_process_group()
    expect_launches("ddp", read_launches(wp, rp), {})
    mp.spawn(ddp_gloo_rank, args=(local_init_method(), str(log_dir)), nprocs=2)
    runs["2 ranks over gloo, one card"] = dict(np.load(log_dir / "ddp_gloo.npz"))
    control = dict(np.load(log_dir / "ddp_control.npz"))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    nets = ("depth_decoder", "pose_decoder", "depth_encoder", "pose_encoder")

    def errors(got, want):
        return {"losses": rel(got["losses"], want["losses"]),
                "stats": rel(got["stats"], want["stats"]),
                **{n: rel(got[f"grad/{n}"], want[f"grad/{n}"]) for n in nets}}

    want = runs.pop("train_step float64")
    for name, got in runs.items():
        err = errors(got, want)
        bad = [k for k, limit in DDP_LIMITS.items() if not err[k] <= limit]
        if bad or not all(np.isfinite(v).all() for v in got.values()):
            raise AssertionError(f"ddp, {name}: against float64 {err}, limits {DDP_LIMITS}")
        between = errors(got, runs["train_step"]) if name != "train_step" else None
        log("ddp", f"{name}, batch {PRETRAIN_B} at {H}x{W}, against the float64 train_step: "
            + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
            + (("; against the float32 train_step: "
                + ", ".join(f"{k} {v:.3g}" for k, v in between.items())) if between else "")
            + f"; {float(got['ms']):.2f} ms/step (host clock, {DDP_STEPS} steps; "
            f"float64 train_step {float(want['ms']):.2f}) [{card}]")
    err = errors(control, want)
    caught = [k for k, limit in DDP_LIMITS.items() if not err[k] <= limit]
    if not caught:
        raise AssertionError(f"ddp: the control (no sync-BN) passes every limit: {err}")
    log("ddp", "control, 2 ranks over gloo without sync-BN, against the float64 train_step: "
        + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
        + f"; outside the limits: {', '.join(caught)} [{card}]")


def phase_profiling(torch, log_dir: Path, card: str) -> None:
    """`utils.profiling.profile_adapt_step` (K = 1, 5, 10) and
    `utils.calibration.calibrate` at 192 x 640, batch 3, on the card, with
    `frame_sol_ms` beside the fitted frame; a class measured faster than
    95% of its speed of light is a failure (that reading is impossible).
    `utils.profiling.trace` around one `adapt_step` must write a Chrome
    trace that holds device kernels."""
    from tpuslam_torch.utils.calibration import HEADER, calibrate, frame_sol_ms
    from tpuslam_torch.utils.profiling import (adapt_state, profile_adapt_step,
                                               random_training_batch, trace)
    from tpuslam_torch.train.steps import LossConfig, adapt_step

    fit = profile_adapt_step(H, W, 3, iters=(1, 5, 10), repeats=4, device="cuda")
    sol = frame_sol_ms(height=H, width=W, batch=3)
    log("profiling", "profile_adapt_step (K1 path, bf16 networks, K = 1, 5, 10, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in fit.items())
        + f"; frame_sol_ms (K = 5, the same route) {sol:.4f} ms [{card}]")
    rows = calibrate(H, W, 3, repeats=6, device="cuda")
    log("profiling", "calibrate: " + " | ".join(HEADER))
    for r in rows:
        log("profiling", "calibrate: " + " | ".join(
            f"{r[k]:.6g}" if isinstance(r[k], float) else r[k] for k in HEADER))
    impossible = [r for r in rows if r["measured_ms"] < 0.95 * r["sol_ms"]]
    if impossible:
        raise AssertionError(f"profiling: measured under 95% of the speed of light: {impossible}")
    if not 0 < sol < fit["ms_frame_K5"]:
        raise AssertionError(f"profiling: frame_sol_ms {sol} against {fit['ms_frame_K5']}")
    state = adapt_state(0, "cuda")
    training = random_training_batch(H, W, 3, 0, "cuda")
    with trace(log_dir / "trace"):
        adapt_step(state, LossConfig(), training, num_steps=1)
        torch.cuda.synchronize()
    events = json.loads((log_dir / "trace" / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("profiling: the trace holds no device kernel")
    log("profiling", f"trace: {len(events)} events, {len(kernels)} device kernels in one "
        f"adapt_step (K = 1) [{card}]")


RUNG_FRAMES = 16  # frames of each rung of the "rungs" phase


def phase_rungs(torch, wp, rp, log_dir: Path, captured: dict, card: str) -> dict:
    """`tpuslam_torch.cli.rungs` at the width of `adapt_kitti.yaml` (192 x
    640, ResNet-18, batch 3; the rungs' own K = 3), 16 frames of the
    synthetic loop each, all five rungs and rung 5's sync ablation, with the
    launch counts read around each rung: rung 1 K1b once a frame; rungs 2,
    4 and 5 sync K1a 3 times a frame; rung 3 also once per generalist
    consolidation (3 in 16 frames); the async rung 5 K1b once a frame and
    K1a 3 times per launched update, with 1 <= adopted <= launched.  Every
    loss finite.  Returns name -> numbers of the rung."""
    import numpy as np

    from tpuslam_torch.cli import rungs
    from tpuslam_torch.slam import Slam

    out = {}
    run = rungs._run

    def counted(name, cfg, dataset, diagnostics=False, device="cuda"):
        reset_launches(wp, rp)
        with PathGuard(wp, rp, captured.setdefault(name, {})):
            slam = run(name, cfg, dataset, diagnostics, device)
        warm = slam.step_times[5:]
        gen = slam.generalist_state
        out[name] = dict(
            launches=read_launches(wp, rp), frames=len(slam.step_times),
            ms=1e3 * float(np.mean(warm)), launched=slam.async_updates_launched,
            adopted=slam.async_updates_adopted, consolidations=gen.step if gen else 0,
            finite=all(math.isfinite(v) for v in slam.depth_loss + slam.velocity_loss),
            loops=slam.pose_graph.num_loop_closures)
        return slam

    consolidate, consolidate_ms = Slam._consolidate_generalist, []

    def timed_consolidate(self):  # host time: the frame is host-bound
        t0 = time.perf_counter()
        consolidate(self)
        consolidate_ms.append(1e3 * (time.perf_counter() - t0))

    rungs._run, Slam._consolidate_generalist = counted, timed_consolidate
    try:
        rungs.main(["--height", str(H), "--width", str(W), "--frames", str(RUNG_FRAMES),
                    "--rungs", "1,2,3,4,5", "--device", "cuda", "--log", str(log_dir / "rungs")])
    finally:
        rungs._run, Slam._consolidate_generalist = run, consolidate
    for name, r in out.items():
        # rung 5 chains two worlds of RUNG_FRAMES // 2 frames
        n = 2 * (RUNG_FRAMES // 2) if name.startswith("rung 5") else RUNG_FRAMES
        if name.startswith("rung 1"):
            want = {"warp_static": n}
        elif name.startswith("rung 3"):
            want = {"warp_static_fused": 3 * n + r["consolidations"]}
        elif name.startswith("rung 5:"):
            want = {"warp_static": n, "warp_static_fused": 3 * r["launched"]}
        else:
            want = {"warp_static_fused": 3 * n}
        expect_launches(name, r["launches"], want)
        if r["frames"] != n or not r["finite"]:
            raise AssertionError(f"{name}: {r}")
        extra = ""
        if name.startswith("rung 3"):
            if r["consolidations"] != n // 5:  # every 5th frame (`generalist_interval`)
                raise AssertionError(f"{name}: {r['consolidations']} consolidations, "
                                     f"not {n // 5}")
            extra = (f", {r['consolidations']} generalist consolidations, host "
                     + " / ".join(f"{ms:.1f}" for ms in consolidate_ms) + " ms each")
        if name.startswith("rung 5:"):
            if not 1 <= r["adopted"] <= r["launched"]:
                raise AssertionError(f"{name}: launched {r['launched']}, adopted {r['adopted']}")
            extra = f", updates launched {r['launched']}, adopted {r['adopted']}"
        log("rungs", f"{name}: launches { {k: v for k, v in r['launches'].items() if v} }, "
            f"steady {r['ms']:.2f} ms/frame (frames 6-{n}), loop edges {r['loops']}{extra} "
            f"[{card}]")
    a, b = out["rung 5: CoVIO async, 2-domain chain"], out["rung 5 sync ablation (same config)"]
    log("rungs", f"rung 5 async / sync, same call: steady {a['ms']:.2f} / {b['ms']:.2f} "
        f"ms/frame ({100 * (a['ms'] / b['ms'] - 1):+.1f}%) [{card}]")
    return out


def phase_async_check(torch, log_dir: Path, card: str) -> None:
    """The CoVIO update on the side stream against the same update on the
    current stream, from one state S at 192 x 640 (after two adapted frames,
    so with Adam state).  `consolidate_step_async` on a side stream, then a
    serving `eval_step` on S on the current stream before the update's
    event is waited on; `consolidate_step` on the current stream from
    `clone_train_state(S)`.  With K = 1 the two updated decoders agree
    within 1e-5 relative; S's networks and Adam state are bit for bit as
    before; the packed readback served before the wait equals one served
    after it.  With K = 5 the same pair is logged beside two runs on the
    current stream: cuDNN's backward sums in no fixed order, and five Adam
    steps carry that to ~1e-3, on one stream as on two.  Whether the update
    was still running on the device when the eval was issued is logged: the
    update's device work ends behind the host's launches (the frame is
    host-bound), and a stream held busy to force the overlap blocks the
    host once many launches wait on it."""
    from tpuslam_torch.slam import Slam
    from tpuslam_torch.train.state import clone_train_state
    from tpuslam_torch.train.steps import consolidate_step, consolidate_step_async, eval_step

    slam = Slam(smoke_config(log_dir, adaptation=True), device="cuda")
    for _ in range(2):
        slam.step()
    S, cfg = slam.state, slam.loss_cfg
    sample = slam.dataset[slam.current_step]
    online = slam._sample_to_batch(sample)
    batch = slam._training_batch(online, sample)
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in S.model.state_dict().items()}
    adam_before = [v.clone() for st in S.optimizer.state.values() for v in st.values()]
    stream = torch.cuda.Stream()

    def decoders(state):
        return torch.cat([v.reshape(-1).double() for k, v in state.model.state_dict().items()
                          if "decoder" in k])

    err, running = {}, {}
    for K in (1, 5):
        ref, ref2 = clone_train_state(S), clone_train_state(S)
        t0 = time.perf_counter()
        clone, event = consolidate_step_async(S, cfg, batch, K, stream)
        launch_ms = 1e3 * (time.perf_counter() - t0)
        running[K] = not event.query()
        _, during = eval_step(S.model, cfg, online)
        event.synchronize()
        consolidate_step(ref, cfg, batch, K)
        consolidate_step(ref2, cfg, batch, K)
        _, after = eval_step(S.model, cfg, online)
        torch.cuda.synchronize()
        err[f"K{K}_side_vs_current"] = rel_err(decoders(clone), decoders(ref))
        err[f"K{K}_current_vs_current"] = rel_err(decoders(ref2), decoders(ref))
        err[f"K{K}_update_size"] = rel_err(decoders(clone), decoders(S))
        err[f"K{K}_served_equal"] = torch.equal(during[("retire_packed",)],
                                                after[("retire_packed",)])
        err[f"K{K}_launch_ms"] = launch_ms
    same_s = all(torch.equal(v, before[k]) for k, v in S.model.state_dict().items())
    same_adam = all(torch.equal(v, w) for v, w in zip(
        [v for st in S.optimizer.state.values() for v in st.values()], adam_before))
    _require(same_s and same_adam and err["K1_served_equal"] and err["K5_served_equal"]
             and err["K1_side_vs_current"] <= 1e-5 and err["K1_update_size"] > 1e-4,
             "async check", dict(err, state_unchanged=same_s, adam_unchanged=same_adam))
    for K in (1, 5):
        log("async check", f"K={K} update on the side stream vs on the current stream: decoders "
            f"relative {err[f'K{K}_side_vs_current']:.3g}, two runs on the current stream "
            f"{err[f'K{K}_current_vs_current']:.3g} (the update moved them "
            f"{err[f'K{K}_update_size']:.3g}); host launch {err[f'K{K}_launch_ms']:.1f} ms; the "
            f"update was {'still' if running[K] else 'no longer'} running on the device when "
            f"the serving eval_step was issued, whose readback equals one after the wait bit "
            f"for bit [{card}]")
    log("async check", "the source state's networks and Adam state are unchanged bit for bit")
    # why no side stream is held busy above to force the overlap: the host
    # then waits in the update's launches
    probe = clone_train_state(S)
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1_000_000_000)  # ~0.5 s of the side stream
        t0 = time.perf_counter()
        consolidate_step(probe, cfg, batch, 1)
        held_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    log("async check", f"with the side stream held by a sleep kernel of 1e9 cycles, the host "
        f"launch of a K=1 update takes {held_ms:.1f} ms ({err['K1_launch_ms']:.1f} ms above with "
        f"the stream free) [{card}]")


def phase_cli_adapt(torch, wp, rp, main_slam, log_dir: Path, captured: dict, card: str) -> None:
    """`Slam.save_model` of the "main" path's Slam, then
    `tpuslam_torch.cli.adapt` on a YAML with `adapt_kitti.yaml`'s settings
    (192 x 640, batch 3, K = 5, loop closure, `pipeline_depth: 3`,
    `plot_frequency` at its default) but `Dataset: Synthetic`, 12 frames and
    `load_weights_folder` set to that checkpoint: a Slam built from the YAML
    holds the saved networks bit for bit; the CLI run writes metrics.pkl,
    log.txt with the trajectory report and models/weights_000/, launching
    K1a 5 times a frame."""
    import yaml

    from tpuslam_torch.cli import adapt
    from tpuslam_torch.config import parse_config
    from tpuslam_torch.slam import Slam

    main_slam.save_model()
    folder = Path(main_slam.log_path) / "models" / "weights_000"
    out = log_dir / "cli_adapt"
    cfg = yaml.safe_load((ROOT / "tpuslam_torch/config/defaults/adapt_kitti.yaml").read_text())
    cfg["Dataset"].update(dataset="Synthetic", num_frames=12)
    cfg["DepthPosePrediction"].update(log_path=str(out), load_weights_folder=str(folder))
    cfg["ReplayBuffer"]["load_path"] = str(out / "replay_buffer")
    path = log_dir / "adapt_kitti_synthetic.yaml"
    path.write_text(yaml.safe_dump(cfg))
    loaded = Slam(parse_config(path), device="cuda").model.state_dict()
    saved = main_slam.model.state_dict()
    if loaded.keys() != saved.keys() or not all(torch.equal(loaded[k], saved[k]) for k in saved):
        raise AssertionError("cli adapt: the loaded networks differ from the saved ones")
    del loaded
    reset_launches(wp, rp)
    t0 = time.perf_counter()
    with PathGuard(wp, rp, captured):
        rc = adapt.main(["--config", str(path), "--device", "cuda", "--no-progress"])
    wall = time.perf_counter() - t0
    launches = read_launches(wp, rp)
    report = (out / "log.txt").read_text() if (out / "log.txt").exists() else ""
    missing = [f for f in ("metrics.pkl", "log.txt", "models/weights_000/model.pt",
                           "models/weights_000/meta.yaml") if not (out / f).exists()]
    if rc != 0 or missing or "Abs traj RMSE" not in report:
        raise AssertionError(f"cli adapt: rc {rc}, missing {missing}, log {report!r}")
    expect_launches("cli adapt", launches, {"warp_static_fused": 5 * 12})
    plots = "ran" if (out / "trajectory.png").exists() else "skipped (see the line above)"
    ate = [l.strip() for l in report.splitlines() if "Abs traj RMSE" in l]
    log("cli adapt", f"saved and reloaded bit for bit; cli.adapt over 12 frames in {wall:.2f} s, "
        f"launches { {k: v for k, v in launches.items() if v} }, {ate}, plotting {plots} [{card}]")


PRETRAIN_B = 18  # the pretrainer's default batch
N_PRETRAIN = 2 * S * PRETRAIN_B  # images per warp in train_step: 144
PRETRAIN_POOL = 24  # distinct synthetic frames the pretrain splits cycle over
CLI_PRETRAIN_FRAMES = 12  # pretrain_collapse_synthetic_192.yaml's 64 frames, cut


def pretrain_split(pool, n: int):
    """n samples cycling over the pool (a list is a Sample dataset)."""
    return [pool[i % len(pool)] for i in range(n)]


def phase_pretrain(torch, wp, rp, log_dir: Path, captured: dict, card: str) -> dict:
    """`Pretrainer` at 192 x 640, ResNet-18, batch 18 (its defaults), on the
    K1a route (`pallas_warp=True`) and the plain sampler: one epoch of 5
    `train_step`s and a `validate` over 2 batches, whose launches must be 5
    K1a (N = 144) and 2 K1b on the K1a route and none on the plain one; then
    a second epoch of 5 steps timed (host clock, ended by the epoch's loss
    read: steady ms/step), and a third of 3 steps under torch.profiler.
    The splits cycle over 24 synthetic frames, made once."""
    from tpuslam_torch.data.synthetic import SyntheticDataset
    from tpuslam_torch.train.pretrain import Pretrainer
    from torch.profiler import ProfilerActivity, profile

    world = SyntheticDataset(num_frames=PRETRAIN_POOL, height=H, width=W, do_augmentation=True)
    pool = [world[i] for i in range(len(world))]
    out = {}
    for route, pallas in (("K1a route", True), ("plain route", False)):
        phase = f"pretrain, {route}"
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        trainer = Pretrainer(height=H, width=W, batch_size=PRETRAIN_B, pallas_warp=pallas,
                             log_path=log_dir / "pretrain", device="cuda")
        reset_launches(wp, rp)
        t0 = time.perf_counter()
        with PathGuard(wp, rp, captured if pallas else {}):
            loss = trainer.train_epoch(pretrain_split(pool, 5 * PRETRAIN_B), progress=False)
            val = trainer.validate(pretrain_split(pool, 2 * PRETRAIN_B))
        first_s = time.perf_counter() - t0
        launches = read_launches(wp, rp)
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        if not (math.isfinite(loss) and math.isfinite(val)):
            raise AssertionError(f"{phase}: loss {loss}, validation loss {val}")
        expect_launches(phase, launches,
                        {"warp_static_fused": 5, "warp_static": 2} if pallas else {})
        t0 = time.perf_counter()
        trainer.train_epoch(pretrain_split(pool, 5 * PRETRAIN_B), progress=False)
        ms = 1e3 * (time.perf_counter() - t0) / 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_epoch(pretrain_split(pool, 3 * PRETRAIN_B), progress=False)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / 3
        spans, by_name, busy_us = device_busy(prof)
        busy_ms = busy_us / 1e3 / 3
        idle = f"{1 - busy_ms / wall_ms:.3f}" if busy_ms > 0 else "not measured"
        out[route] = dict(ms=ms, wall_ms=wall_ms, busy_ms=busy_ms, peak=peak, launches=launches)
        top = ", ".join(f"{n[:50]} {us / 1e3 / 3:.3f}" for n, us in by_name.most_common(6))
        log(phase, f"epoch of 5 steps + validate (2 batches) in {first_s:.2f} s, loss "
            f"{loss:.5f}, validation loss {val:.5f}, launches "
            f"{ {k: v for k, v in launches.items() if v} }; steady {ms:.2f} ms/step (host "
            f"clock, 5 steps, batch prep included); profiled 3 steps: wall {wall_ms:.2f} "
            f"ms/step, device busy {busy_ms:.2f} ms/step, idle share {idle}, "
            f"{len(spans) / 3:.0f} device activities/step; peak memory {peak:.2f} GiB above "
            f"the {held / 2 ** 30:.2f} GiB held before [{card}]")
        log(phase, f"top device time, ms/step: {top}")
        del trainer, prof
        torch.cuda.empty_cache()
    a, b = out["K1a route"], out["plain route"]
    log("pretrain", f"K1a route / plain route, same call: steady {a['ms']:.2f} / {b['ms']:.2f} "
        f"ms/step; device busy {a['busy_ms']:.2f} / {b['busy_ms']:.2f} ms/step; peak memory "
        f"{a['peak']:.2f} / {b['peak']:.2f} GiB [{card}]")
    return out["K1a route"]["launches"]


def phase_cli_pretrain(torch, wp, rp, log_dir: Path, captured: dict, card: str) -> None:
    """`tpuslam_torch.cli.pretrain --config pretrain_collapse_synthetic_192.yaml
    --epochs 2`, called in this process (so that the launches can be read),
    with `num_frames` cut from 64 to 12 and `log_path` in the run's
    directory: the plain sampler (no launch of the port's kernels), the
    `weights_*` folders and models/best.yaml; then a `Pretrainer` built from
    the same YAML resumes through `load` and trains one more epoch."""
    import yaml

    from tpuslam_torch.cli import pretrain
    from tpuslam_torch.config import parse_config

    cfg = yaml.safe_load(
        (ROOT / "tpuslam_torch/config/defaults/pretrain_collapse_synthetic_192.yaml").read_text())
    out = log_dir / "cli_pretrain"
    cfg["Dataset"]["num_frames"] = CLI_PRETRAIN_FRAMES
    cfg["DepthPosePrediction"]["log_path"] = str(out)
    path = log_dir / "pretrain_collapse_synthetic_192.yaml"
    path.write_text(yaml.safe_dump(cfg))
    reset_launches(wp, rp)
    t0 = time.perf_counter()
    with PathGuard(wp, rp, captured):
        rc = pretrain.main(["--config", str(path), "--epochs", "2"])
    wall = time.perf_counter() - t0
    expect_launches("cli pretrain", read_launches(wp, rp), {})
    models = out / "models"
    best = yaml.safe_load((models / "best.yaml").read_text()) if (models / "best.yaml").exists() \
        else None
    if rc != 0 or not (models / "weights_002" / "model.pt").exists() or best is None:
        raise AssertionError(f"cli pretrain: rc {rc}, folders "
                             f"{sorted(p.name for p in models.glob('*'))}, best {best}")
    parsed = parse_config(path)
    trainer = pretrain.make_pretrainer(parsed, "cuda").load()
    if trainer.epoch != 2:
        raise AssertionError(f"cli pretrain: resumed at epoch {trainer.epoch}")
    loss = trainer.train_epoch(pretrain.build_dataset(parsed, "train"), progress=False)
    folder = trainer.save()
    if not (math.isfinite(loss) and folder.name == "weights_003"):
        raise AssertionError(f"cli pretrain: resumed epoch loss {loss}, saved {folder}")
    log("cli pretrain", f"cli.pretrain --epochs 2 ({CLI_PRETRAIN_FRAMES} of the YAML's 64 "
        f"frames, batch 3) in {wall:.2f} s with no kernel launch (plain sampler): "
        f"{sorted(p.name for p in models.glob('weights_*'))}, best {best}; resumed at "
        f"epoch 2 through Pretrainer.load, epoch 3 loss {loss:.5f} [{card}]")


def device_busy(prof):
    """The device activities of a torch.profiler trace: their (start, end)
    spans, their time by name (us), and the union of the spans (busy us)."""
    from collections import Counter

    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    by_name = Counter()
    for e in events:
        by_name[e.name] += e.time_range.end - e.time_range.start
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return spans, by_name, busy_us


def phase_profile(torch, slam, card: str, phase: str, frames: int = 3) -> dict:
    """Where a frame's time goes: host time making the synthetic frame,
    the rest of `Slam.step`, and the device's busy time (union of the
    kernel and copy intervals that torch.profiler records) by kernel."""
    from collections import Counter

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
    spans, by_name, busy_us = device_busy(prof)
    wall_ms, busy_ms = 1e3 * wall_s / frames, busy_us / 1e3 / frames
    if busy_ms <= 0.0:
        log(phase, f"{wall_ms:.2f} ms/frame wall; device time not measured "
            f"(the profiler recorded no device activity) [{card}]")
        return dict(wall_ms=wall_ms)
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=1 - busy_ms / wall_ms,
               activities=len(spans) / frames, data_ms=1e3 * data_s / frames)
    top = ", ".join(f"{name[:60]} {us / 1e3 / frames:.3f}" for name, us in by_name.most_common(8))
    ours = Counter()
    for name, us in by_name.items():
        for kernel in ("warp_kernel", "warp_grad_kernel", "err_fwd_kernel", "err_bwd_kernel"):
            if kernel in name:
                ours[kernel] += us
    log(phase, f"{frames} frames: wall {wall_ms:.2f} ms/frame, synthetic frame "
        f"{out['data_ms']:.2f} ms/frame, device busy {busy_ms:.2f} ms/frame "
        f"(idle share {out['idle']:.3f}), {out['activities']:.0f} device "
        f"activities/frame [{card}]")
    log(phase, f"top device time, ms/frame: {top}")
    log(phase, "the port's kernels, ms/frame: "
        + ", ".join(f"{k} {us / 1e3 / frames:.3f}" for k, us in ours.items()))
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


def phase_reference_train(torch, tag: str, use_pallas_warp: bool) -> None:
    """One `train_step` (batch norm in train mode, every parameter) on the
    card, on the CPU and on the CPU in float64 (the plain sampler: the
    kernels take float32 only) from the same weights and batch, at 64 x 384,
    batch 2, noise off.  The card must agree with the float64 step within
    1e-3 relative on the losses and the running statistics after the step,
    and within 3e-3 on all gradients as one vector: in the deep layers batch
    norm over few values per channel amplifies float32 rounding, and the
    card's gradient read 9.3e-4 from float64 here (its pose encoder's 1.2e-3)
    where the CPU's float32 one is 1.3e-2 away (PERF.md).  The float32
    CPU step is logged beside it."""
    import dataclasses

    import numpy as np

    from tpuslam_torch.data.synthetic import SyntheticDataset
    from tpuslam_torch.models.depth_pose import init_depth_pose
    from tpuslam_torch.train.batch import make_frame_batch
    from tpuslam_torch.train.state import make_pretrain_optimizer, make_train_state
    from tpuslam_torch.train.steps import LossConfig, train_step

    height, width = 64, 384
    ds = SyntheticDataset(num_frames=3, height=height, width=width, do_augmentation=True)
    samples = [ds[i] for i in range(2)]
    cfg = LossConfig(use_pallas_warp=use_pallas_warp, pallas_bf16_out=False,
                     bf16_networks=False)
    got = {}
    for run, dev in (("card", "cuda"), ("cpu", "cpu"), ("cpu64", "cpu")):
        model = init_depth_pose(0, device=dev)
        batch = make_frame_batch(np.stack([s.rgb for s in samples]), ds.K,
                                 np.stack([s.rel_dist for s in samples]),
                                 rgb_aug=np.stack([s.aug for s in samples]), device=dev)
        step_cfg = cfg
        if run == "cpu64":
            model = model.double()
            batch = dataclasses.replace(
                batch, rgb=batch.rgb.double() / 255, rgb_aug=batch.rgb_aug.double() / 255,
                K=batch.K.double(), inv_K=batch.inv_K.double(),
                rel_dist=batch.rel_dist.double(), weights=batch.weights.double())
            step_cfg = cfg._replace(use_pallas_warp=False)
        state = make_train_state(model, make_pretrain_optimizer(model, 1e-4), seed=None)
        losses = train_step(state, step_cfg, batch)
        got[run] = dict(
            losses=np.array([float(losses[k]) for k in sorted(losses)]),
            grads={k: (torch.zeros_like(p) if p.grad is None else p.grad).double().cpu().numpy()
                   for k, p in model.named_parameters()},
            stats=np.concatenate([v.double().cpu().numpy().ravel()
                                  for k, v in model.state_dict().items() if "running" in k]))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def cat(grads, prefix=""):
        return np.concatenate([g.ravel() for k, g in grads.items() if k.startswith(prefix)])

    def errors(a, b):
        return dict(losses=rel(a["losses"], b["losses"]),
                    grads=rel(cat(a["grads"]), cat(b["grads"])),
                    stats=rel(a["stats"], b["stats"]),
                    **{n: rel(cat(a["grads"], n), cat(b["grads"], n))
                       for n in ("depth_encoder", "pose_encoder", "depth_decoder",
                                 "pose_decoder")})

    card = errors(got["card"], got["cpu64"])
    cpu = errors(got["cpu"], got["cpu64"])
    both = errors(got["card"], got["cpu"])
    finite = all(np.isfinite(v).all() for v in got["card"].values() if isinstance(v, np.ndarray))
    if not (finite and max(card["losses"], card["stats"]) <= 1e-3 and card["grads"] <= 3e-3):
        raise AssertionError(f"train_step ({tag}) card vs float64: {card}")
    for name, err in (("card vs CPU float64", card), ("CPU float32 vs float64", cpu),
                      ("card vs CPU float32", both)):
        log("reference", f"train_step ({tag}) {height}x{width} batch 2, {name}: "
            + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))


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
    from tpuslam_torch.tools.warp_ab import proj_inputs, warp_inputs

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

    # the pretrain path: K1a under train_step, K1b in validate, both bf16
    k1p, k1pv = cap["pretrain"]["warp_static_fused"], cap["pretrain"]["warp_static"]
    if ([tuple(k[0].shape) for k in (k1p, k1pv)] != [(N_PRETRAIN, H, W, C)] * 2
            or (k1p[2], k1pv[2:]) != (True, (True,))):
        raise AssertionError(f"pretrain inputs: {[tuple(k[0].shape) for k in (k1p, k1pv)]}, "
                             f"flags {k1p[2:]}, {k1pv[2:]}")
    e1p = [check_k1(torch, wp, *k1p[:2], f"the pretrain path's inputs (N = {N_PRETRAIN})"),
           check_k1(torch, wp, *k1pv[:2], f"the pretrain validate's inputs (N = {N_PRETRAIN})")]
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
    edges = check_warp_edges(torch, wp, dev)
    e1, e4, e5 = e1 + edges["K1"], e4 + edges["K4"], e5 + edges["K5"]
    preds, target, gerr, (dx, dy) = err_inputs(dev, N_MAIN, 3)
    e6 = [check_err(torch, rp, preds, target, gerr, dx, dy, "adversarial preds"),
          check_err(torch, rp, *k7, "the fused main path's inputs"),
          check_err(torch, rp, *k6b, *k7[3:], "the fused-loss path's preds and g")]
    # shapes that no tile divides, the smallest the pools take, and a channel
    # count other than 3 (the kernels' other staging)
    for shape in ((6, 3, 50, 130), (4, 2, 2, 70), (3, 1, 37, 2), (2, 1, 40, 70, 4)):
        preds, target, gerr, (dx, dy) = err_inputs(dev, *shape)
        e6.append(check_err(torch, rp, preds, target, gerr, dx, dy, "adversarial preds"))
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
    for name, taps, bf16, (src, coords), errs in (
        ("warp_static_fused", True, True, k1a[:2], e1),
        ("warp_static_fused_f32", True, False, k1a[:2], e1),
        ("warp_static", False, True, k1b[:2], e1),
        ("warp_static_f32", False, False, k1b[:2], e1),
        ("warp_static_fused_pretrain", True, True, k1p[:2], e1p),
        ("warp_static_pretrain", False, True, k1pv[:2], e1p),
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
            worst(errs, [key]), None if taps else _grid_sample_ms(torch, src, coords))

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
    e2 += edges["K2"]
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
    timed(torch, card, "K2's forward on the two-kernel eval path's inputs",
          lambda: wp.warp_static(src, coords), lambda: wp.warp_two_kernel_plain(src, coords),
          "warp_kernel", (src, coords), (src,), src.shape[0] * H * W * fwd_flops,
          worst(e2, ["fwd_exact"]), _grid_sample_ms(torch, src, coords))

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
    from tpuslam_torch.posegraph import native as pg_native

    card = card_line()
    log("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 is "
        f"off inside the port's entry points")

    t0 = time.perf_counter()
    build.build_kernels()
    wp.load_library()
    rp.load_library()
    log("build", f"warp.cu and reproj.cu built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc, each started together: {build.build_seconds or 'cached'})")
    t0 = time.perf_counter()
    pg_native.library()
    log("build", f"native/posegraph.cc built with g++ and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({pg_native.library_path().name})")

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
            torch, wp, rp, "main", log_dir, cap.setdefault("main", {}), card, 8, k1_taps)
        k1_prof = phase_profile(torch, slam, card, "profile")
        phase_cli_adapt(torch, wp, rp, slam, log_dir, cap.setdefault("cli adapt", {}), card)
        del slam
        eval_launches = run_eval_path(torch, wp, rp, "eval", log_dir, cap.setdefault("eval", {}),
                                      {"warp_static": 2})
        two_launches, slam, two_ms = run_adapt_path(
            torch, wp, rp, "two-kernel main", log_dir, cap.setdefault("two-kernel main", {}),
            card, 8, two_kernel, pallas_fused_grad=False)
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
            torch, wp, rp, "fused main", log_dir, cap.setdefault("fused main", {}), card, 8,
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
        lc_ms = phase_lc_main(torch, wp, rp, log_dir, cap.setdefault("lc main", {}), card, k1_ms)
        phase_lc_mobilenet(torch, wp, rp, log_dir, card, lc_ms)
        phase_rungs(torch, wp, rp, log_dir, cap.setdefault("rungs", {}), card)
        phase_async_check(torch, log_dir, card)
        pretrain_launches = phase_pretrain(torch, wp, rp, log_dir, cap.setdefault("pretrain", {}),
                                           card)
        phase_cli_pretrain(torch, wp, rp, log_dir, cap.setdefault("cli pretrain", {}), card)
        phase_ddp(torch, wp, rp, log_dir, card)
        phase_profiling(torch, log_dir, card)
        results = phase_kernels(torch, wp, rp, cap, card)
        cap.clear()
        phase_reference(torch, log_dir, "K1 path")
        phase_reference(torch, log_dir, "fused stack", **FUSED)
        # the K1 path at the two-kernel routes' size tells the size's share
        # of their card-vs-CPU difference from the route's
        phase_reference(torch, log_dir, "K1 path", 64, 384)
        phase_reference(torch, log_dir, "two-kernel path", 64, 384, pallas_fused_grad=False)
        phase_reference(torch, log_dir, "packed", 64, 384, pallas_packed=True)
        phase_reference_train(torch, "K1a route", True)
        phase_reference_train(torch, "plain route", False)

    warp_src, err_src = "tpuslam_torch/csrc/warp.cu", "tpuslam_torch/csrc/reproj.cu"
    # (name, source, TPU kernel, launches on its path, counter, timing):
    # K1b and K2's forward are one launch without taps, one counter; K3 and
    # K3' are K2 with exact taps (no path calls pallas_warp), so their rows
    # carry K2's launches and times; K1a and K1b have a second row each on
    # the pretrain path (N = 144)
    kernels = [
        ("warp_static_fused", warp_src, "tpuslam/ops/pallas_warp.py:1244", k1_launches,
         "warp_static_fused", "warp_static_fused"),
        ("warp_static", warp_src, "tpuslam/ops/pallas_warp.py:745", eval_launches,
         "warp_static", "warp_static"),
        ("warp_static_fused_pretrain", warp_src, "tpuslam/ops/pallas_warp.py:1244",
         pretrain_launches, "warp_static_fused", "warp_static_fused_pretrain"),
        ("warp_static_pretrain", warp_src, "tpuslam/ops/pallas_warp.py:745", pretrain_launches,
         "warp_static", "warp_static_pretrain"),
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
