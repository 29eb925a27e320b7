"""Per-op-class device calibration: measured time against speed of light.

Counterpart of `tpuslam/utils/calibration.py`, on the card's own peaks.
Each op class of the adapt step is run at its real shapes (192 x 640,
batch 3, by default) and gets:

- its measured time, ms per call between CUDA events (`profiling.device_ms`);
- its operations, counted by `torch.utils.flop_counter.FlopCounterMode`
  (matrix products and convolutions; the hand-written kernels count none);
- its compulsory bytes, from `analytic_bytes`;
- its speed of light on one NVIDIA H100 SXM,

      sol_ms = max(flops / peak, bytes / HBM bandwidth),

  with the peak of the type the class computes in, and which of the two
  bounds it (`bound`: "operations" or "bytes"), and `sol_frac` = sol_ms /
  measured_ms, its share of the roofline.

`frame_sol_ms` composes the speed of light of a whole frame (encoders + K
iterations) for a given routing of the warp and the loss.  The JAX package
ran on a relay far slower than the chip and projected native v5e times from
its measurements (`project_native_fps*`); on the card the measured time is
already the native one, so nothing is projected here.

`python -m tpuslam_torch.utils.calibration` prints the table (on the card;
`--device cpu` runs the classes' plain versions at a size of your choice).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from tpuslam_torch import full_fp32, resolve_device
from tpuslam_torch.geometry.camera import bilinear_sampler
from tpuslam_torch.losses.photometric import total_loss
from tpuslam_torch.models.depth_pose import DepthPoseNet
from tpuslam_torch.ops.reproj import reproj_err
from tpuslam_torch.ops.warp import warp, warp_tall, warp_two_kernel
from tpuslam_torch.train.steps import LossConfig, _decode_and_loss, _frozen_features, _networks
from tpuslam_torch.utils.profiling import adapt_state, device_ms, random_training_batch

# NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense rates at 700 W
PEAK_HBM_BYTES = 3.35e12  # H100 SXM: HBM3, 3.35 TB/s
PEAK_FLOPS_F32 = 67e12  # H100 SXM: float32 outside the tensor cores
PEAK_FLOPS_TF32 = 495e12  # H100 SXM: TF32 tensor cores, dense
PEAK_FLOPS_BF16 = 989e12  # H100 SXM: bf16 tensor cores, dense

CLASSES = (
    "matmul_bf16_4096", "matmul_tf32_4096", "encoder_fwd", "decoder_fwd", "iter_fwd_bwd",
    "loss_fwd_bwd", "warp_pallas_fwd_bwd", "warp_pallas_packed_fwd_bwd",
    "warp_pallas_fused_fwd_bwd", "warp_tall_fwd_bwd", "loss_pallas_fwd_bwd",
    "warp_xla_fwd_bwd", "adam_update",
)


def _flops(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _fwd_bwd(f, x: torch.Tensor):
    """The forward of `f` at a fresh leaf copy of `x` and its backward."""
    def run():
        leaf = x.detach().requires_grad_(True)
        f(leaf).float().sum().backward()
    return run


def calibrate(
    height: int = 192,
    width: int = 640,
    batch_size: int = 3,
    repeats: int = 6,
    seed: int = 0,
    classes: Optional[List[str]] = None,
    device="cuda",
) -> List[Dict]:
    """Time each op class of the adapt step (all of `CLASSES`, or those
    named) and set it against its speed of light; one row dict per class.

    The classes and what they run: two 4096 x 4096 matrix products (bf16,
    TF32) as reference rows; the frozen encoders; the decoders' forward;
    one adaptation iteration (decoders, warp and loss, backward); the loss
    alone, forward and backward, on given warped images; the warps forward
    and backward at the step's 8B-image stack: K2 exact (`warp_pallas`) and
    with truncated taps (`warp_pallas_packed`; the seg-skip route runs the
    same kernel), K1a with bf16 taps (`warp_pallas_fused`), K4 over the 2B
    deduplicated sources (`warp_tall`), the plain sampler (`warp_xla`); the
    error-map kernels K6 and K6' (`loss_pallas`); one Adam step over the
    decoders.  On the CPU each kernel's plain version runs."""
    device = resolve_device(device)
    H, W, B = height, width, batch_size
    rng = np.random.default_rng(seed)
    cfg = LossConfig()
    state = adapt_state(seed, device)
    model = state.model
    training = random_training_batch(H, W, B, seed, device)
    with full_fp32():
        depth_feats, pose_feat = _frozen_features(model, training, cfg)

    def tensor(*shape, low=0.0, high=1.0, dtype=torch.float32):
        return torch.from_numpy(rng.uniform(low, high, size=shape).astype(np.float32)).to(
            device=device, dtype=dtype)

    def encoders():
        _frozen_features(model, training, cfg)

    def decoders():
        with torch.no_grad(), _networks(cfg.bf16_networks, device):
            model.depth_decode(depth_feats)
            model.pose_decode(pose_feat)

    def iteration():
        losses, _ = _decode_and_loss(model, training, cfg, depth_feats, pose_feat)
        losses["loss"].backward()

    maps = 8 * B  # 2 directions x 4 scales x B
    src = tensor(maps, H, W, 3)
    coords = tensor(maps, H, W, 2) * torch.tensor([W - 1.0, H - 1.0], device=device)
    target = tensor(B, H, W, 3)

    inputs = {("rgb", f, 0): tensor(B, H, W, 3) for f in (0, -1, 1)}
    for s in (1, 2, 3):
        inputs[("rgb", 0, s)] = tensor(B, H // 2**s, W // 2**s, 3)
    for f in (0, 1):
        inputs[("relative_distance", f)] = tensor(B, low=0.5, high=2.0)
    loss_outputs = {}
    for s in (0, 1, 2, 3):
        for f in (-1, 1):
            loss_outputs[("rgb", f, s)] = tensor(B, H, W, 3)
        loss_outputs[("disp", s)] = tensor(B, H // 2**s, W // 2**s, 1, low=0.01)
    for f in (-1, 1):
        loss_outputs[("translation", 0, f)] = tensor(B, 3)

    def loss_fwd_bwd():
        outputs = {k: v.detach().requires_grad_(True) for k, v in loss_outputs.items()}
        total_loss(inputs, outputs, scales=(0, 1, 2, 3))["loss"].backward()

    for p in model.parameters():
        if p.requires_grad:  # the decoders
            p.grad = torch.ones_like(p)

    def adam():
        state.optimizer.step()

    a16 = tensor(4096, 4096, dtype=torch.bfloat16)
    a32 = tensor(4096, 4096)

    def matmul_tf32():
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            (a32 @ a32).sum()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    net_peak = PEAK_FLOPS_BF16 if cfg.bf16_networks else PEAK_FLOPS_F32
    table = {
        "matmul_bf16_4096": (lambda: (a16 @ a16).sum(), PEAK_FLOPS_BF16),
        "matmul_tf32_4096": (matmul_tf32, PEAK_FLOPS_TF32),
        "encoder_fwd": (encoders, net_peak),
        "decoder_fwd": (decoders, net_peak),
        "iter_fwd_bwd": (iteration, net_peak),
        "loss_fwd_bwd": (loss_fwd_bwd, PEAK_FLOPS_F32),
        "warp_pallas_fwd_bwd": (_fwd_bwd(lambda c: warp_two_kernel(src, c), coords),
                                PEAK_FLOPS_F32),
        "warp_pallas_packed_fwd_bwd": (
            _fwd_bwd(lambda c: warp_two_kernel(src, c, trunc=True), coords), PEAK_FLOPS_F32),
        "warp_pallas_fused_fwd_bwd": (_fwd_bwd(lambda c: warp(src, c, bf16_out=True), coords),
                                      PEAK_FLOPS_F32),
        "warp_tall_fwd_bwd": (_fwd_bwd(lambda c: warp_tall(src[:2 * B], c, 4), coords),
                              PEAK_FLOPS_F32),
        "loss_pallas_fwd_bwd": (_fwd_bwd(lambda p: reproj_err(p, target), src), PEAK_FLOPS_F32),
        "warp_xla_fwd_bwd": (_fwd_bwd(lambda c: bilinear_sampler(src, c), coords),
                             PEAK_FLOPS_F32),
        "adam_update": (adam, PEAK_FLOPS_F32),
    }
    ana = analytic_bytes(H, W, B, 4, act_bytes=2 if cfg.bf16_networks else 4)
    ana["warp_pallas_fused_fwd_bwd"] = analytic_bytes(
        H, W, B, 4, out_dtype_bytes=2)["warp_pallas_fused_fwd_bwd"]
    rows = []
    for name in CLASSES:
        if classes is not None and name not in classes:
            continue
        fn, peak = table[name]
        with full_fp32():
            for _ in range(2):  # cuDNN autotuning, warm-up
                fn()
            ms = device_ms(fn, repeats, device)
            flops = _flops(fn)
        flops_ms = flops / peak * 1e3
        bytes_ms = ana[name] / PEAK_HBM_BYTES * 1e3
        sol_ms = max(flops_ms, bytes_ms)
        rows.append({
            "class": name,
            "measured_ms": ms,
            "gflops": flops / 1e9,
            "ana_gbytes": ana[name] / 1e9,
            "sol_ms": sol_ms,
            "bound": "operations" if flops_ms > bytes_ms else "bytes",
            "sol_frac": sol_ms / ms,
        })
    return rows


def analytic_bytes(height: int = 192, width: int = 640, batch: int = 3, scales: int = 4,
                   dtype_bytes: int = 4, out_dtype_bytes: int = 4,
                   act_bytes: int = 4) -> Dict[str, float]:
    """The bytes each op class must move through device memory at least:
    each stage's inputs read once, its outputs written once, weights once
    (the JAX package's inventory, `tpuslam/utils/calibration.py:311`).

    Two departures from the JAX inventory.  Its windowed and column-stripe
    warp kernels re-read a window of the source per output tile, which it
    counted; the port's warps gather the taps of each output pixel from the
    source itself, so the source counts once (the S-tiled stack for K1 and
    K2, the 2B deduplicated frames for K4 and K5).  And the networks'
    activations take `act_bytes` (2 under bf16 autocast).  Also counted:
    the two reference matrix products.  `out_dtype_bytes` = 2 models bf16
    warp outputs and taps."""
    B, H, W, D = batch, height, width, dtype_bytes
    OD, A = out_dtype_bytes, act_bytes
    img = H * W * 3 * D

    def resnet18_acts(h, w, b):
        # conv1 -> maxpool -> 4 stages x 2 basic blocks (2 convs each):
        # the input and output of every conv, and the skip reads
        t = b * (h * w * 3 + h // 2 * (w // 2) * 64) * A
        t += b * (h // 2 * (w // 2) * 64 + h // 4 * (w // 4) * 64) * A
        for ch, red in ((64, 4), (128, 8), (256, 16), (512, 32)):
            hw = (h // red) * (w // red)
            t += 4 * b * hw * ch * 2 * A + 2 * b * hw * ch * A
        return t

    resnet_w = 11.7e6 * D  # ~11.7M parameters per ResNet-18 encoder
    encoders = resnet18_acts(H, W, B) + resnet18_acts(H, W, 2 * B) + 2 * resnet_w

    dec = 0.0
    for ch, red in ((256, 16), (128, 8), (64, 4), (32, 2), (16, 1)):
        hw = (H // red) * (W // red)
        dec += B * hw * ch * 2 * 2 * A + B * hw * ch * A
    dec += scales * B * H * W * 2 * A + 3.2e6 * D
    pose_dec = B * (H // 32) * (W // 32) * 256 * 6 * A + 1.6e6 * D

    maps = 2 * scales * B
    coords = maps * H * W * 2 * D
    out_img = H * W * 3 * OD
    src = maps * img  # K1 / K2: the S-tiled source stack
    src_dedup = 2 * B * img  # K4 / K5: the 2B distinct source frames
    err_maps = maps * H * W * 4
    depth_k = scales * B * H * W * D

    # K2: forward (source, coordinates, output); backward (source and
    # coordinates again, the incoming gradient, the coordinate gradient)
    warp_two = (src + coords + maps * out_img) + (src + coords + maps * out_img + coords)
    # K1a: the forward also stores dx and dy; the backward contracts them
    # with the incoming gradient into the coordinate gradient
    warp_fused = (src + coords + 3 * maps * out_img) + (3 * maps * out_img + coords)
    warp_tall = (src_dedup + coords + 3 * maps * out_img) + (3 * maps * out_img + coords)
    warp_loss_fused_bwd = (
        src_dedup + coords + 3 * maps * out_img + maps * out_img + B * img + err_maps
        + maps * out_img + B * img + err_maps + 2 * maps * out_img + coords)
    warp_loss_fused_bwd_proj = (
        src_dedup + 2 * depth_k + 3 * maps * out_img + maps * out_img + B * img + err_maps
        + maps * out_img + B * img + err_maps + 2 * maps * out_img + coords)
    loss = 3 * (maps + 2) * img + maps * H * W * D
    loss_fused = (maps * out_img + B * img + err_maps) + (
        maps * out_img + B * img + err_maps + maps * out_img)
    adam = 4 * 2 * (3.2e6 + 1.6e6) * D
    return {
        "matmul_bf16_4096": 3 * 4096 * 4096 * 2,
        "matmul_tf32_4096": 3 * 4096 * 4096 * 4,
        "encoder_fwd": encoders,
        "decoder_fwd": dec + pose_dec,
        "iter_fwd_bwd": 2.2 * (dec + pose_dec) + warp_two + loss,
        "warp_pallas_fwd_bwd": warp_two,
        "warp_pallas_packed_fwd_bwd": warp_two,
        "warp_pallas_fused_fwd_bwd": warp_fused,
        "warp_tall_fwd_bwd": warp_tall,
        "warp_xla_fwd_bwd": warp_two,
        "warp_loss_fused_bwd": warp_loss_fused_bwd,
        "warp_loss_fused_bwd_proj": warp_loss_fused_bwd_proj,
        "loss_fwd_bwd": loss,
        "loss_pallas_fwd_bwd": loss_fused,
        "adam_update": adam,
        "coords_fwd_bwd": 4 * (scales * B * H * W * (1 + 3 + 2) * D),
        "coords_fwd_bwd_proj": 2 * depth_k,
        "mask_smooth": 3 * maps * H * W * 4 + 2 * B * img,
    }


def network_gflops(height: int = 192, width: int = 640, batch: int = 3) -> Dict[str, float]:
    """Operations of the frozen encoders' forward (depth encoder on B images,
    pose encoder on 2B pairs) and of the decoders' forward and backward, in
    GFLOP, counted on the meta device (nothing is computed)."""
    with torch.device("meta"):
        model = DepthPoseNet().eval()
        images = torch.empty(batch, height, width, 3)
        pairs = torch.empty(2 * batch, height, width, 6)
    with torch.no_grad(), FlopCounterMode(display=False) as enc:
        feats = model.depth_encode(images)
        pose_feat = model.pose_encode(pairs)[-1]
    with FlopCounterMode(display=False) as dec:
        disps = model.depth_decode([f.detach() for f in feats])
        aa, tr = model.pose_decode(pose_feat.detach())
        (sum(d.sum() for d in disps.values()) + aa.sum() + tr.sum()).backward()
    return {"encoders": enc.get_total_flops() / 1e9, "decoders_fwd_bwd": dec.get_total_flops() / 1e9}


def frame_sol_ms(
    adapt_iters: int = 5,
    bf16: bool = True,
    tall: bool = False,
    fused_loss: bool = False,
    fused_bwd: bool = False,
    proj: bool = False,
    bf16_out: bool = False,
    height: int = 192,
    width: int = 640,
    batch: int = 3,
) -> float:
    """The least time one H100 SXM could take for an adapt-step frame of
    this routing: the encoders once and `adapt_iters` times the decoders
    forward and backward, the warp and the loss, the coordinates, the
    masks and smoothness and Adam, each stage at max(operations / peak,
    analytic bytes / HBM bandwidth).  `bf16`: the networks under bf16
    autocast; `tall`, `fused_loss`, `fused_bwd`, `proj`: the `pallas_*`
    routes (K4, K6, K7/K8, K5); `bf16_out`: bf16 warp outputs.  A measured
    frame on the card is set against this directly: it is the native time,
    not a projection."""
    ana = analytic_bytes(height, width, batch, 4, out_dtype_bytes=2 if bf16_out else 4,
                         act_bytes=2 if bf16 else 4)
    peak = PEAK_FLOPS_BF16 if bf16 else PEAK_FLOPS_F32
    gflops = network_gflops(height, width, batch)

    def hbm_ms(name):
        return ana[name] / PEAK_HBM_BYTES * 1e3

    enc_ms = max(gflops["encoders"] * 1e9 / peak * 1e3, hbm_ms("encoder_fwd"))
    dec_ms = max(gflops["decoders_fwd_bwd"] * 1e9 / peak * 1e3,
                 2.2 * hbm_ms("decoder_fwd"))
    if tall and fused_loss and fused_bwd and proj:
        warp_loss = hbm_ms("warp_loss_fused_bwd_proj")
    elif tall and fused_loss and fused_bwd:
        warp_loss = hbm_ms("warp_loss_fused_bwd")
    elif tall and fused_loss:
        warp_loss = hbm_ms("warp_tall_fwd_bwd") + hbm_ms("loss_pallas_fwd_bwd")
    elif tall:
        warp_loss = hbm_ms("warp_tall_fwd_bwd") + hbm_ms("loss_fwd_bwd")
    elif fused_loss:
        warp_loss = hbm_ms("warp_pallas_fused_fwd_bwd") + hbm_ms("loss_pallas_fwd_bwd")
    else:  # the shipped route: K1a and the loss in PyTorch
        warp_loss = hbm_ms("warp_pallas_fused_fwd_bwd") + hbm_ms("loss_fwd_bwd")
    coords = hbm_ms("coords_fwd_bwd_proj" if proj else "coords_fwd_bwd")
    per_iter = dec_ms + warp_loss + coords + hbm_ms("mask_smooth") + hbm_ms("adam_update")
    return enc_ms + adapt_iters * per_iter


HEADER = ("class", "measured_ms", "gflops", "ana_gbytes", "sol_ms", "bound", "sol_frac")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="per-op-class calibration of the adapt step")
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}")
    rows = calibrate(args.height, args.width, args.batch, args.repeats, device=device)
    print(" | ".join(HEADER))
    for r in rows:
        print(" | ".join(f"{r[k]:.6g}" if isinstance(r[k], float) else r[k] for k in HEADER))
    print(f"frame_sol_ms (K=5, shipped route): "
          f"{frame_sol_ms(height=args.height, width=args.width, batch=args.batch):.4f}")


if __name__ == "__main__":
    main()
