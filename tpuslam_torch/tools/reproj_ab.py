"""Compare two builds of the error-map kernels (`csrc/reproj.cu`) on one GPU.

    python3 -m tpuslam_torch.tools.reproj_ab OLD.cu [NEW.cu] [--out FILE]

NEW defaults to the package's own source; an earlier version comes from git,
e.g. `git show <commit>:tpuslam_torch/csrc/reproj.cu > build/reproj_old.cu`.
Both are built with the package's nvcc flags plus `-Xptxas -v`: registers,
shared memory and spills of each kernel are printed.  Their K6, K6' and
K7/K8 outputs on the same inputs (f32 and bf16 preds and taps) are compared
bit for bit.  Then each kernel is timed in turns, old, new, new, old, at the
fused paths' shape (24 x 192 x 640 x 3 against 3 targets, bf16 preds and
taps) on random images with exact-tie and constant patches: device time
from CUDA events around each launch, the 50 MB L2 flushed (a 256 MB write)
before it, mean of 20 launches after 5 warm-ups.  The card's name and power
limit are printed beside the times; with --out the results go to a JSON
file as well.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from pathlib import Path

import torch

from tpuslam_torch.ops import build
from tpuslam_torch.ops import reproj as rp
from tpuslam_torch.tools.ab_common import card_line, cold_ms, compile_source, flush_buffer

N, B, H, W, C = 24, 3, 192, 640, 3


def label(mangled: str) -> str:
    """`err_bwd_kernel<Lb1>` and the like, from a kernel's mangled name."""
    m = re.search(r"(err_\w+?_kernel)I(\w+?)E", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def make_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    target = torch.rand((B, H, W, C), generator=g, device=dev)
    preds = torch.rand((N, H, W, C), generator=g, device=dev)
    preds[0, :40, :100] = target[0, :40, :100]  # exact ties at the border
    preds[2, 12:21, 58:71] = target[2, 12:21, 58:71]  # and inside
    target[0, 60:90, 200:260] = 0.5  # constant and equal
    preds[0, 60:90, 200:260] = 0.5
    gerr = torch.randn((N, H, W), generator=g, device=dev)
    taps = [torch.randn((N, H, W, C), generator=g, device=dev) for _ in range(2)]
    return preds, target, gerr, taps


def calls(preds, target, gerr, dx, dy):
    return {"K6": lambda: rp.reproj_err_fwd(preds, target),
            "K6'": lambda: rp.reproj_err_bwd(preds, target, gerr),
            "K7/K8": lambda: rp.err_bwd_coords(preds, target, gerr, dx, dy)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path, nargs="?", default=build.CSRC / "reproj.cu")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("reproj_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda")
    result = {"card": card, "old": str(args.old), "new": str(args.new)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for tag, source in (("old", args.old), ("new", args.new)):
            libs[tag], usage = compile_source("reproj", source, Path(tmp), rp.declare,
                                               label=label)
            result[f"{tag}_usage"] = usage
            for line in usage:
                print(f"[{tag}] {line}")
        preds, target, gerr, (dx, dy) = make_inputs(dev)
        for dtype in (torch.float32, torch.bfloat16):
            p, tx, ty = preds.to(dtype), dx.to(dtype), dy.to(dtype)
            outs = {}
            for tag, lib in libs.items():
                rp._configured = lib
                outs[tag] = [fn() for fn in calls(p, target, gerr, tx, ty).values()]
            equal = {k: bool(torch.equal(a, b))
                     for k, a, b in zip(("K6", "K6'", "K7/K8"), outs["old"], outs["new"])}
            result[f"bit_equal_{str(dtype)[6:]}"] = equal
            print(f"new vs old, {dtype}: bit-equal {equal}")
        flush = flush_buffer(dev)
        p, tx, ty = preds.to(torch.bfloat16), dx.to(torch.bfloat16), dy.to(torch.bfloat16)
        times = {}
        for tag in ("old", "new", "new", "old"):
            rp._configured = libs[tag]
            for name, fn in calls(p, target, gerr, tx, ty).items():
                times.setdefault(tag, {}).setdefault(name, []).append(cold_ms(fn, flush))
        rp._configured = None
    result["cold_ms"] = times
    for tag, per in times.items():
        print(f"{tag}: " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in per.items())
              + f" (device, L2 flushed; two turns) [{card}]")
    if args.out:
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
