#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`tpuslam_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line and raising on failure (exit code != 0):

1. device: the card's name and power limit;
2. build: the warp kernel (tpuslam_torch/csrc/warp.cu) built with nvcc;
3. main path: `Slam.step` with online adaptation on the synthetic world at
   192 x 640, ResNet-18 depth and pose, batch 3, K = 5, the shipped
   `pallas_*` defaults; K1 runs with taps on N = 2*S*B = 24 images;
4. profile: three more frames under torch.profiler give the host / device
   split of a frame;
5. eval path: two frames with `adaptation: false`, where the batch is 1 and
   K1 runs without taps on N = 2*S = 8 images;
6. kernels: K1 with taps and without, f32 and bf16 outputs, and its autograd
   backward, held against the plain torch versions on adversarial inputs
   and on the inputs the two paths gave it; then timed on the latter beside
   the plain versions, torch's grid_sample and the bound;
7. reference: the same adaptation step on the card and on the CPU at a
   small size, which must agree.

During phases 3 and 5 every plain warp refuses CUDA tensors, and the
kernel's launch counts are read just after each.

The line before the last holds the kernels as JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the repository
beside it, the script exits with an error and prints no result.
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
N_MAIN = 24  # images per warp in adapt_step: 2 directions x 4 scales x batch 3
N_EVAL = 8  # in eval_step (`adaptation: false`), where the batch is 1


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


def warp_inputs(device, n: int):
    """n distinct images in [0, 1] and pixel-grid coords plus smooth random
    flow, with points outside the image, exact-edge ties and integer
    coordinates."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(n)
    src = torch.rand((n, H, W, C), generator=g, device=device)
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
        taps_f32=max(float((a - b).abs().max()) for a, b in zip(got, plain)),
        taps_bf16=max(float((a.float() - b.to(bf16).float()).abs().max())
                      for a, b in zip(got16, plain)),
        taps_bf16_ulps=max(max_bf16_ulps(a, b.to(bf16)) for a, b in zip(got16, plain)),
        notaps_f32=float((nt - plain_nt).abs().max()),
        notaps_bf16=float((nt16.float() - plain_nt.to(bf16).float()).abs().max()),
        notaps_bf16_ulps=max_bf16_ulps(nt16, plain_nt.to(bf16)),
    )
    gout = torch.randn(src.shape, generator=torch.Generator(device=src.device).manual_seed(1),
                       device=src.device)
    ck = coords.clone().requires_grad_()
    (wp.warp(src, ck, False) * gout).sum().backward()
    cp = coords.clone().requires_grad_()
    (wp.warp_static_fused_plain(src, cp)[0] * gout).sum().backward()
    err["dcoords_rel"] = float((ck.grad - cp.grad).norm() / cp.grad.norm())
    if not (err["taps_f32"] <= 1e-5 and err["notaps_f32"] <= 1e-5
            and err["taps_bf16_ulps"] <= 1.0 and err["notaps_bf16_ulps"] <= 1.0
            and err["dcoords_rel"] <= 1e-4):
        raise AssertionError(f"K1 vs plain on {tag}: {err}")
    log("kernels", f"K1 vs plain on {tag}, src {tuple(src.shape)}: "
        + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))
    return err


def device_ms(torch, fn, match: str, iters: int = 20) -> float:
    """Mean device duration of the kernel whose name holds `match`, one
    launch of `fn` per iteration with the 50 MB L2 flushed before it (a
    256 MB write), read from torch.profiler's CUDA trace: no host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(2 ** 26, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    warm = 3  # the trace may miss the first launches after it starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(warm + iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and match in e.name)
    if not iters <= len(spans) <= warm + iters:
        raise AssertionError(f"profiler saw {len(spans)} '{match}' kernels in "
                             f"{warm + iters} calls")
    return sum(e - s for s, e in spans[-iters:]) / iters / 1e3


def phase_kernels(torch, wp, captured: dict, card: str):
    """Hold K1 against its plain versions on adversarial inputs and on the
    inputs the main path (N = 2*S*B = 24, with taps) and the eval path
    (N = 2*S*1 = 8, without taps) gave it, then time it on the latter."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    shapes = {k: tuple(v[0].shape) for k, v in captured.items()}
    if shapes != {"taps": (N_MAIN, H, W, C), "notaps": (N_EVAL, H, W, C)}:
        raise AssertionError(f"K1 inputs of the paths: {shapes}")
    errs = [check_k1(torch, wp, *warp_inputs(dev, N_MAIN), "adversarial coords"),
            check_k1(torch, wp, *warp_inputs(dev, N_EVAL), "adversarial coords"),
            check_k1(torch, wp, *captured["taps"], "the main path's inputs"),
            check_k1(torch, wp, *captured["notaps"], "the eval path's inputs")]

    results = {}
    for name, taps, bf16, (src, coords) in (
        ("warp_static_fused", True, True, captured["taps"]),
        ("warp_static_fused_f32", True, False, captured["taps"]),
        ("warp_static", False, True, captured["notaps"]),
        ("warp_static_f32", False, False, captured["notaps"]),
    ):
        fn = wp.warp_static_fused if taps else wp.warp_static
        plain = wp.warp_static_fused_plain if taps else wp.bilinear_sampler
        ms = device_ms(torch, lambda: fn(src, coords, bf16), "warp_kernel")
        warm_ms = time_ms(lambda: fn(src, coords, bf16))
        plain_ms = time_ms(lambda: plain(src, coords))
        outs = fn(src, coords, bf16)
        outs = outs if taps else (outs,)
        flops = coords.shape[0] * H * W * ((10 + 22 * C) if taps else (10 + 9 * C))
        bms, by = bound_ms((src, coords), outs, flops)
        key = ("taps" if taps else "notaps") + ("_bf16" if bf16 else "_f32")
        err = max(e[key] for e in errs)
        lib_ms = lib_warm = None
        if not taps:
            n = coords.shape[0]
            grid = torch.stack([coords[..., 0] / (W - 1) * 2 - 1,
                                coords[..., 1] / (H - 1) * 2 - 1], -1)
            src_nchw = src.permute(0, 3, 1, 2).contiguous()

            def grid_sample():
                return F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="border",
                                     align_corners=True)

            lib_ms = device_ms(torch, grid_sample, "grid_sampler")
            lib_warm = time_ms(grid_sample)
        results[name] = dict(ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                             plain_ms=plain_ms, library_ms=lib_ms)
        log("kernels", f"{name} at {tuple(src.shape)}: kernel {ms:.4f} ms (device, L2 "
            f"flushed), {warm_ms:.4f} ms (back to back, events); bound {bms:.4f} ms ({by}); "
            f"plain {plain_ms:.4f} ms"
            + (f"; grid_sample {lib_ms:.4f} ms (device, L2 flushed), {lib_warm:.4f} ms "
               f"(back to back)" if lib_ms is not None else "") + f" [{card}]")

    # the main path tiles each of its 2*B source images S times; the same
    # coordinates on 24 distinct images tell whether that changes the time
    src, coords = captured["taps"]
    distinct = warp_inputs(torch.device("cuda"), N_MAIN)[0]
    ms_distinct = device_ms(torch, lambda: wp.warp_static_fused(distinct, coords, True),
                            "warp_kernel")
    log("kernels", f"warp_static_fused bf16 on the main path's coords: tiled source "
        f"{results['warp_static_fused']['ms']:.4f} ms, 24 distinct images {ms_distinct:.4f} ms "
        f"(device, L2 flushed) [{card}]")
    return results


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


class PathGuard:
    """While a path runs: a CUDA tensor must never reach a plain warp, and
    the last inputs the path gave K1 with and without taps are kept (by
    reference: the path does not write to them afterwards)."""

    NAMES = ("warp_static_fused_plain", "bilinear_sampler", "warp_static_fused", "warp_static")

    def __init__(self, wp, captured: dict):
        self.wp, self.captured = wp, captured
        self.orig = {name: getattr(wp, name) for name in self.NAMES}

    def __enter__(self):
        def plain_guard(fn):
            def guarded(src, coords):
                if src.is_cuda or coords.is_cuda:
                    raise AssertionError("a CUDA tensor reached the plain warp")
                return fn(src, coords)
            return guarded

        def capture(fn, key):
            def kept(src, coords, bf16_out=False):
                self.captured[key] = (src, coords)
                return fn(src, coords, bf16_out)
            return kept

        o = self.orig
        self.wp.warp_static_fused_plain = plain_guard(o["warp_static_fused_plain"])
        self.wp.bilinear_sampler = plain_guard(o["bilinear_sampler"])
        self.wp.warp_static_fused = capture(o["warp_static_fused"], "taps")
        self.wp.warp_static = capture(o["warp_static"], "notaps")

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.wp, name, fn)


def phase_main_path(torch, wp, log_dir: Path, captured: dict, card: str):
    import numpy as np

    from tpuslam_torch.slam import Slam

    slam = Slam(smoke_config(log_dir, adaptation=True), device="cuda")
    steps, losses = 12, []
    torch.cuda.reset_peak_memory_stats()
    wp.reset_launches()
    with PathGuard(wp, captured):
        for _ in range(steps):
            losses.append(slam.step())
    launches, notaps = wp.warp_launches, wp.warp_notaps_launches
    adapted = len(slam.step_times)
    bad = [l for l in losses if not all(math.isfinite(v) for v in l.values())]
    if bad or adapted == 0:
        raise AssertionError(f"non-finite losses {bad} or no adapted frame")
    if slam.pose_graph.vertex_ids != list(range(adapted + 1)):
        raise AssertionError(f"pose graph vertices {slam.pose_graph.vertex_ids}")
    if launches != 5 * adapted or notaps != 0:
        raise AssertionError(f"warp launches {launches} (taps) / {notaps} (no taps) "
                             f"for {adapted} adapted frames at K = 5")
    steady = slam.step_times[2:]
    ms = 1e3 * float(np.mean(steady))
    log("main", f"{adapted} frames adapted, loss {losses[-1]['loss']:.5f}, K1 launches "
        f"{launches}, replay buffer {len(slam.replay_buffer)}, steady {ms:.2f} ms/frame = "
        f"{1e3 / ms:.2f} frames/s (frames 3-{steps}), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return launches, slam


def phase_profile(torch, slam, card: str, frames: int = 3):
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
        log("profile", f"{wall_ms:.2f} ms/frame wall; device time not measured "
            f"(the profiler recorded no device activity) [{card}]")
        return
    top = ", ".join(f"{name[:60]} {us / 1e3 / frames:.3f}" for name, us in by_name.most_common(8))
    log("profile", f"{frames} frames: wall {wall_ms:.2f} ms/frame, synthetic frame "
        f"{1e3 * data_s / frames:.2f} ms/frame, device busy {busy_ms:.2f} ms/frame "
        f"(idle share {1 - busy_ms / wall_ms:.3f}), {len(spans) / frames:.0f} device "
        f"activities/frame [{card}]")
    log("profile", f"top device time, ms/frame: {top}")


def phase_reference(torch, log_dir: Path):
    """One adapt_step on the card (K1) and on the CPU (plain version) from
    the same weights and batch, at 64 x 192, float32, noise off.  cuDNN sums
    in another order than the CPU, and Adam's first step normalises each
    gradient, so the two agree to ~1e-5, not to the last bit."""
    import numpy as np

    from tpuslam_torch.data.synthetic import SyntheticDataset
    from tpuslam_torch.models.depth_pose import init_depth_pose
    from tpuslam_torch.train.batch import make_frame_batch, pad_batch
    from tpuslam_torch.train.state import make_adapt_optimizer, make_train_state
    from tpuslam_torch.train.steps import adapt_step, loss_config

    pc = smoke_config(log_dir, True, 64, 192, dtype="float32",
                      pallas_bf16_out=False).depth_pose
    cfg = loss_config(pc)
    sample = SyntheticDataset(num_frames=4, height=64, width=192)[1]
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
        raise AssertionError(f"adapt_step card vs CPU: relative error {rel} > 1e-3")
    log("reference", f"adapt_step 64x192 K=2 float32, card vs CPU packed readback: "
        f"relative error {rel:.3g}")


def phase_eval_path(torch, wp, log_dir: Path, captured: dict):
    from tpuslam_torch.slam import Slam

    slam = Slam(smoke_config(log_dir, adaptation=False), device="cuda")
    wp.reset_launches()
    with PathGuard(wp, captured):
        losses = [slam.step() for _ in range(2)]
    launches, notaps = wp.warp_launches, wp.warp_notaps_launches
    if not all(math.isfinite(l["loss"]) for l in losses):
        raise AssertionError(f"eval path losses {losses}")
    if notaps != 2 or launches != 0:
        raise AssertionError(f"eval path: {notaps} launches without taps, {launches} with")
    log("eval", f"2 frames, loss {losses[-1]['loss']:.5f}, K1 without taps launched {notaps}x "
        f"on {tuple(captured['notaps'][0].shape)}")
    return notaps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpuslam_torch.ops import warp as wp

    card = card_line()
    log("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 is "
        f"off inside the port's entry points")

    t0 = time.perf_counter()
    wp.load_library()
    log("build", f"warp.cu loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {wp.build_seconds if wp.build_seconds is not None else 'cached'} s)")

    captured = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log_dir = Path(tmp)
        k1a_launches, slam = phase_main_path(torch, wp, log_dir, captured, card)
        phase_profile(torch, slam, card)
        del slam
        k1b_launches = phase_eval_path(torch, wp, log_dir, captured)
        results = phase_kernels(torch, wp, captured, card)
        phase_reference(torch, log_dir)

    source = "tpuslam_torch/csrc/warp.cu"
    kernels = [
        dict(name="warp_static_fused", route="cuda", source=source,
             replaces="tpuslam/ops/pallas_warp.py:1244", launches=k1a_launches,
             **results["warp_static_fused"]),
        dict(name="warp_static", route="cuda", source=source,
             replaces="tpuslam/ops/pallas_warp.py:745", launches=k1b_launches,
             **results["warp_static"]),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
