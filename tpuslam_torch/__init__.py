"""PyTorch / CUDA port of tpuslam for one NVIDIA H100.

A second package beside `tpuslam` (the JAX reference), with the same module
layout.  Its entry points run on the card by default and raise when CUDA is
absent; pass `device="cpu"` to run the plain versions of the kernels on the
CPU.  It imports nothing of JAX and nothing of `tpuslam`.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device to run on; refuses CUDA when there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: tpuslam_torch runs on the GPU unless the "
            "caller passes device='cpu'"
        )
    return device


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32 when it comes in a narrower float type (the bf16
    outputs of autocast); float32 and float64 pass unchanged, so that the
    networks and the geometry follow a float64 input."""
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


@contextmanager
def full_fp32():
    """Run float32 matmuls and convolutions in full float32 (TF32 off), and
    restore the caller's settings on exit.  Also a decorator.

    TF32 keeps about three decimal digits, which moves warp coordinates by
    ~0.1 px.  Geometry, warp and losses are always float32; the networks are
    float32 under `dtype: float32` and bf16 (autocast) under `bfloat16`.  The
    entry points that run on the card (`adapt_step`, `eval_step`, `embed`)
    are wrapped in it, so no caller has to set process-wide flags."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
