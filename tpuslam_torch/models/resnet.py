"""ResNet-18/34 feature-pyramid encoder.

Counterpart of `tpuslam/models/resnet.py`: input normalisation
(x - 0.45) / 0.225 in the forward pass, five feature stages with channels
(64, 64, 128, 256, 512), and a multi-image stem (conv1 over 3 *
num_input_images channels) for the pose network.  Modules carry the
monodepth2 / torchvision names (`resnet.conv1`, `resnet.layer1.0.conv1`,
`...downsample.0`), so reference `.pth` state dicts load directly.

Takes NHWC images and returns NCHW feature maps in float32 (the tensors are
channels-last in memory, which is cuDNN's fast layout).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn
import torch.nn.functional as F

RESNET_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
ENCODER_CHANNELS = (64, 64, 128, 256, 512)


def _bn(channels: int) -> nn.BatchNorm2d:
    # flax BatchNorm(momentum=0.9, epsilon=1e-5) == torch momentum 0.1
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False), _bn(planes)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class _ResNet(nn.Module):
    """The torchvision ResNet trunk without its classifier."""

    def __init__(self, num_layers: int, in_channels: int):
        super().__init__()
        if num_layers not in RESNET_STAGES:
            raise ValueError(f"Unsupported ResNet depth: {num_layers}")
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        inplanes = 64
        for i, (blocks, planes) in enumerate(zip(RESNET_STAGES[num_layers],
                                                 ENCODER_CHANNELS[1:])):
            stride = 1 if i == 0 else 2
            layer = [BasicBlock(inplanes, planes, stride)]
            layer += [BasicBlock(planes, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            inplanes = planes


class ResNetEncoder(nn.Module):
    """Five-stage feature pyramid; `num_input_images` stacks RGB channel-wise."""

    num_ch_encoder: Tuple[int, ...] = ENCODER_CHANNELS

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        self.resnet = _ResNet(num_layers, 3 * num_input_images)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, 3 * num_input_images) in [0, 1] -> 5 NCHW feature maps."""
        r = self.resnet
        x = ((x - 0.45) / 0.225).permute(0, 3, 1, 2)
        f0 = F.relu(r.bn1(r.conv1(x)))
        x = F.max_pool2d(f0, 3, 2, 1)
        features = [f0]
        for layer in (r.layer1, r.layer2, r.layer3, r.layer4):
            x = layer(x)
            features.append(x)
        return [f.float() for f in features]
