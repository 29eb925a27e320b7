"""Compare two builds of the warp kernels (`csrc/warp.cu`) on one GPU.

    python3 -m tpuslam_torch.tools.warp_ab OLD.cu [NEW.cu] [--out FILE]

NEW defaults to the package's own source; an earlier version comes from git,
e.g. `git show <commit>:tpuslam_torch/csrc/warp.cu > build/warp_old.cu`.
Both are built with the package's nvcc flags plus `-Xptxas -v`: registers,
shared memory and spills of each instantiation are printed.  Every output of
the two builds on the same inputs is compared bit for bit: out, dx and dy of
K1a (bf16 and f32), K1b, K2's forward exact and truncated, K4 and K5 with and
without taps, and the dcoords of K2's backward (`warp_grad_kernel`), exact and
truncated.  The inputs (`warp_inputs`, `proj_inputs`, which `chip_smoke.py`
uses too) are random images and smooth random flow with points off the
image, exact-edge ties and integer coordinates (K5: smooth depth with a near
band that projects off the image), at the paths' shapes (N = 24 and N = 8
images of 192 x 640 x 3), at shapes that no run or vector width divides
(50 x 130, 2 x 70, 37 x 2, C = 4 and C = 1 at 40 x 70), and once with the
coordinates and depth at an odd element offset.  Then each instantiation is
timed in turns, old, new, new, old, at its path's shape: device time from
CUDA events around each launch, the 50 MB L2 flushed (a 256 MB write) before
it, mean of 20 launches after 5 warm-ups.  The card's name and power limit
are printed beside the times; with --out the results go to a JSON file as
well.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from tpuslam_torch.geometry.camera import projection_affine
from tpuslam_torch.ops import build
from tpuslam_torch.ops import warp as wp
from tpuslam_torch.tools.ab_common import card_line, cold_ms, compile_source, flush_buffer

H, W, C = 192, 640, 3  # the system's frames
S = 4  # scales
# (case, S, B, H, W, C): N = 2*S*B warped images read 2*B sources for K4/K5;
# K1 and K2 read N sources
CASES = [("adapt path", S, 3, H, W, C), ("eval path", S, 1, H, W, C),
         ("50x130", 3, 1, 50, 130, 3), ("2x70", 2, 1, 2, 70, 3), ("37x2", 1, 2, 37, 2, 3),
         ("C = 4", 2, 1, 40, 70, 4), ("C = 1", 2, 1, 40, 70, 1)]
# timed row -> (call, the case whose shape its path gives it)
TIMED = {"K1a": ("K1a bf16", "adapt path"), "K1a f32": ("K1a f32", "adapt path"),
         "K1b": ("K1b bf16", "eval path"), "K2 fwd": ("K2 fwd", "adapt path"),
         "K2 fwd trunc": ("K2 fwd trunc", "adapt path"), "K2 fwd eval": ("K2 fwd", "eval path"),
         "K4": ("K4 bf16", "adapt path"), "K5": ("K5 bf16", "adapt path"),
         "K5 no taps": ("K5 no taps bf16", "eval path"), "K2 bwd": ("K2 bwd", "adapt path"),
         "K2 bwd trunc": ("K2 bwd trunc", "adapt path")}


def warp_inputs(device, n: int, n_src: Optional[int] = None, shape=(H, W, C)):
    """n_src distinct images (h, w, c) = shape in [0, 1] (n by default) and n
    pixel-grid coordinate fields plus smooth random flow, with points
    outside the image, exact-edge ties and integer coordinates (rows past a
    small shape's edge are cut by the slicing)."""
    h, w, c = shape
    g = torch.Generator(device=device).manual_seed(n)
    src = torch.rand((n_src or n, h, w, c), generator=g, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    coarse = torch.randn((n, 2, 6, 20), generator=g, device=device) * 6.0
    flow = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    coords = torch.stack([xs + flow[:, 0], ys + flow[:, 1]], dim=-1)
    coords[:, :, :8, 0] = -3.5  # left of the image
    coords[:, 100:104, :, 1] = h + 20.0  # below the image
    coords[:, 0, :, 1] = 0.0  # top edge, exact tie
    coords[:, :, -1, 0] = w - 1.0  # right edge, exact tie
    coords[:, 50:52] = torch.floor(coords[:, 50:52])  # integer coordinates
    return src, coords.contiguous()


def proj_inputs(device, B: int, shape=(H, W, C), scales: int = S):
    """depth (scales*B, h, w, 1) and affine maps (2B, 12) of a KITTI-like
    camera and small random poses, with a near region that projects outside
    the image and a far one; plus 2B source images (h, w, c) = shape."""
    h, w, c = shape
    g = torch.Generator(device=device).manual_seed(B)
    src2 = torch.rand((2 * B, h, w, c), generator=g, device=device)
    depth = 2.0 + 30.0 * torch.rand((scales * B, 1, 6, 20), generator=g, device=device)
    depth = F.interpolate(depth, size=(h, w), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    depth[:, :20, :] = 0.3  # near: leaves the image
    K = torch.eye(4, device=device).repeat(2 * B, 1, 1)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    T = torch.eye(4, device=device).repeat(2 * B, 1, 1)
    T[:, :3, 3] = 0.3 * torch.randn((2 * B, 3), generator=g, device=device)
    ab = projection_affine(K, torch.linalg.inv(K), T)
    return src2, depth.contiguous(), ab.contiguous()


def odd_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts one element past an aligned
    address, so that no vector access to it is aligned."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return view.copy_(t)


def make_case(dev, S: int, B: int, H: int, W: int, C: int) -> dict:
    """Every call's inputs at one shape: N = 2*S*B coordinate fields and
    sources (K1, K2) with K2's cotangent g, and 2*B sources with S*B depths
    (K4, K5)."""
    src, coords = warp_inputs(dev, 2 * S * B, shape=(H, W, C))
    src2, depth, ab = proj_inputs(dev, B, (H, W, C), S)
    g = torch.randn(src.shape, generator=torch.Generator(device=dev).manual_seed(S * B),
                    device=dev)
    return dict(src=src, src2=src2, coords=coords, g=g, depth=depth, ab=ab, S=S)


def calls(case: dict) -> dict:
    src, src2, coords, g = case["src"], case["src2"], case["coords"], case["g"]
    depth, ab, S = case["depth"], case["ab"], case["S"]
    return {
        "K1a bf16": lambda: wp.warp_static_fused(src, coords, True),
        "K1a f32": lambda: wp.warp_static_fused(src, coords, False),
        "K1b bf16": lambda: wp.warp_static(src, coords, True),
        "K2 fwd": lambda: wp.warp_static(src, coords, False),
        "K2 fwd trunc": lambda: wp.warp_static(src, coords, False, True),
        "K4 bf16": lambda: wp.warp_tall_taps(src2, coords, S, True),
        "K4 f32": lambda: wp.warp_tall_taps(src2, coords, S, False),
        "K4 no taps bf16": lambda: wp.warp_tall_notaps(src2, coords, S, True),
        "K4 no taps f32": lambda: wp.warp_tall_notaps(src2, coords, S, False),
        "K5 bf16": lambda: wp.warp_tall_proj_taps(src2, depth, ab, S, True),
        "K5 f32": lambda: wp.warp_tall_proj_taps(src2, depth, ab, S, False),
        "K5 no taps bf16": lambda: wp.warp_tall_proj_notaps(src2, depth, ab, S, True),
        "K5 no taps f32": lambda: wp.warp_tall_proj_notaps(src2, depth, ab, S, False),
        "K2 bwd": lambda: wp.warp_static_bwd(src, coords, g),
        "K2 bwd trunc": lambda: wp.warp_static_bwd(src, coords, g, True),
    }


def outputs(lib, case: dict) -> dict:
    wp._configured = lib
    outs = {name: fn() for name, fn in calls(case).items()}
    torch.cuda.synchronize()
    return {k: v if isinstance(v, tuple) else (v,) for k, v in outs.items()}


def compare(old: dict, new: dict) -> dict:
    """name -> None where every output is bit-identical, else the number of
    differing values and the largest difference."""
    diff = {}
    for name in old:
        bits = [torch.cat([t.flatten().view(torch.uint8) for t in d[name]]) for d in (old, new)]
        a, b = (torch.cat([t.float().flatten() for t in d[name]]) for d in (old, new))
        diff[name] = None if torch.equal(*bits) else dict(
            values=int((a != b).sum()), max_abs=float((a - b).abs().max()))
    return diff


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path, nargs="?", default=build.CSRC / "warp.cu")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("warp_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda")
    result = {"card": card, "old": str(args.old), "new": str(args.new)}
    identical = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for tag, source in (("old", args.old), ("new", args.new)):
            libs[tag], usage = compile_source("warp", source, Path(tmp), wp.declare)
            result[f"{tag}_usage"] = usage
            for line in usage:
                print(f"[{tag}] {line}")
        cases = {name: make_case(dev, *shape) for name, *shape in CASES}
        odd = dict(cases["50x130"], coords=odd_offset(cases["50x130"]["coords"]),
                   depth=odd_offset(cases["50x130"]["depth"]))
        for name, case in list(cases.items()) + [("50x130, coords and depth at an odd offset", odd)]:
            diff = compare(outputs(libs["old"], case), outputs(libs["new"], case))
            bad = {k: v for k, v in diff.items() if v is not None}
            identical &= not bad
            result.setdefault("bit_equal", {})[name] = {k: v is None for k, v in diff.items()}
            shape = tuple(case["src"].shape)
            print(f"new vs old on {name} {shape}: " + (
                f"all {len(diff)} bit-identical" if not bad else f"NOT bit-identical: {bad}"))
        del odd
        flush = flush_buffer(dev)
        times = {}
        for tag in ("old", "new", "new", "old"):
            wp._configured = libs[tag]
            for name, (call, case_name) in TIMED.items():
                fn = calls(cases[case_name])[call]
                times.setdefault(tag, {}).setdefault(name, []).append(cold_ms(fn, flush))
        wp._configured = None
    result["cold_ms"] = times
    result["identical"] = identical
    for name in TIMED:
        old, new = times["old"][name], times["new"][name]
        print(f"{name} at the {TIMED[name][1]}: old {old[0]:.4f} / {old[1]:.4f}, new {new[0]:.4f} / "
              f"{new[1]:.4f} ms, new/old {sum(new) / sum(old):.3f} (device, L2 flushed; two "
              f"turns) [{card}]")
    if args.out:
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
