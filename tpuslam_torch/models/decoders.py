"""Depth (U-Net) and pose decoders.

Counterpart of `tpuslam/models/decoders.py`: five up-stages of ConvBlock ->
nearest upsample to the skip's size -> skip concat -> ConvBlock, with sigmoid
disparity heads at the requested scales computed in float32 (float64 in a
float64 model); the pose head is squeeze-1x1 + three convs -> global mean ->
0.01 scaling.  Module names
follow the monodepth2 checkpoints (`upconv_{i}_{j}.conv.conv`,
`dispconv_{s}.conv`, `squeeze`, `pose_{k}`).

Features come in NCHW; disparities leave in NHWC (B, H, W, 1).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from tpuslam_torch import at_least_f32

DECODER_CHANNELS = (16, 32, 64, 128, 256)


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """Reflection pad of one pixel on H and W of an NCHW tensor, as
    `jnp.pad(mode="reflect")`: an axis of size 1 (the stage-4 map at H or
    W = 32) repeats its one row, where torch's reflect pad refuses it."""
    h, w = x.shape[-2:]
    if h > 1 and w > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    x = F.pad(x, (1, 1, 0, 0), mode="reflect" if w > 1 else "replicate")
    return F.pad(x, (0, 0, 1, 1), mode="reflect" if h > 1 else "replicate")


class Conv3x3(nn.Module):
    """Reflection-pad-1 + 3x3 valid conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(reflect_pad1(x))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    """U-Net decoder over the 5-stage encoder pyramid -> multi-scale disparity."""

    def __init__(self, num_ch_encoder=(64, 64, 128, 256, 512),
                 scales: Tuple[int, ...] = (0, 1, 2, 3)):
        super().__init__()
        self.scales = tuple(scales)
        for i in range(4, -1, -1):
            ch_in = num_ch_encoder[-1] if i == 4 else DECODER_CHANNELS[i + 1]
            setattr(self, f"upconv_{i}_0", ConvBlock(ch_in, DECODER_CHANNELS[i]))
            ch_in = DECODER_CHANNELS[i] + (num_ch_encoder[i - 1] if i > 0 else 0)
            setattr(self, f"upconv_{i}_1", ConvBlock(ch_in, DECODER_CHANNELS[i]))
        for s in self.scales:
            setattr(self, f"dispconv_{s}", Conv3x3(DECODER_CHANNELS[s], 1))

    def forward(self, features: Sequence[torch.Tensor]) -> Dict[Tuple[str, int], torch.Tensor]:
        outputs = {}
        x = features[-1]
        for i in range(4, -1, -1):
            x = getattr(self, f"upconv_{i}_0")(x)
            if i > 0:
                skip = features[i - 1]
                x = F.interpolate(x, size=skip.shape[2:], mode="nearest")
                x = torch.cat([x, skip.to(x.dtype)], dim=1)
            else:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"upconv_{i}_1")(x)
            if i in self.scales:
                disp = getattr(self, f"dispconv_{i}")(x)
                outputs[("disp", i)] = torch.sigmoid(at_least_f32(disp)).permute(0, 2, 3, 1)
        return outputs


class PoseDecoder(nn.Module):
    """Pose regression head on the last encoder stage (`num_ch_in` channels,
    the encoder's last width) -> (axis_angle, translation), each
    (B, num_frames_to_predict_for, 3), scaled by 0.01."""

    def __init__(self, num_ch_in: int = 512, num_frames_to_predict_for: int = 2):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.squeeze = nn.Conv2d(num_ch_in, 256, 1)
        self.pose_0 = nn.Conv2d(256, 256, 3, 1, 1)
        self.pose_1 = nn.Conv2d(256, 256, 3, 1, 1)
        self.pose_2 = nn.Conv2d(256, 6 * num_frames_to_predict_for, 1)

    def forward(self, last_feature: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.squeeze(last_feature))
        x = F.relu(self.pose_0(x))
        x = F.relu(self.pose_1(x))
        x = at_least_f32(self.pose_2(x)).mean((2, 3))
        x = 0.01 * x.reshape(-1, self.num_frames, 6)
        return x[..., :3], x[..., 3:]
