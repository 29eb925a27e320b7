"""The networks' weights, made on the card from the seed: convolution kernels
LeCun-normal (variance 1 / fan-in) from one draw of a torch.Generator,
biases 0, batch norm at identity statistics.  One state dict, monodepth2
names, loaded by the program and by the reference alike, with the encoders
at the configuration's `resnet_depth` and `resnet_pose`."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def encoder_depths(section: dict) -> Tuple[int, int]:
    """(resnet_depth, resnet_pose) of a configuration's section, 18 where it
    names none."""
    return int(section.get("resnet_depth", 18)), int(section.get("resnet_pose", 18))


def seeded_state_dict(seed: int, scales, device, resnet_depth: int = 18,
                      resnet_pose: int = 18) -> Dict[str, torch.Tensor]:
    from portbench.reference.nets import DepthPoseNet

    with torch.device("meta"):
        shapes = DepthPoseNet(scales, resnet_depth, resnet_pose=resnet_pose)
    names = {n: t for n, t in shapes.state_dict().items()}
    convs = [n for n, t in names.items() if n.endswith("weight") and t.dim() == 4]
    total = sum(names[n].numel() for n in convs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for n in convs:
        t = names[n]
        fan_in = t.shape[1] * t.shape[2] * t.shape[3]
        out[n] = flat[offset:offset + t.numel()].view(t.shape) * (1.0 / math.sqrt(fan_in))
        offset += t.numel()
    for n, t in names.items():
        if n in out:
            continue
        if n.endswith("num_batches_tracked"):
            out[n] = torch.zeros((), dtype=torch.long, device=device)
        elif n.endswith("running_var") or (n.endswith("weight") and t.dim() == 1):
            out[n] = torch.ones(t.shape, device=device)
        else:
            out[n] = torch.zeros(t.shape, device=device)
    return out
