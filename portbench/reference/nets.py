"""Plain float32 monodepth2 networks: ResNet depth and pose encoders, the
U-Net depth decoder and the pose decoder (Godard et al., ICCV 2019, as
CL-SLAM uses them).

The encoders hold the depths monodepth2 offers (`--num_layers`), as
torchvision's trunks without `fc` (He et al., CVPR 2016, table 1):
- 18 and 34: BasicBlock, stages (2, 2, 2, 2) and (3, 4, 6, 3), channels
  (64, 64, 128, 256, 512);
- 50: Bottleneck (1x1, 3x3 with the stride, 1x1 to 4x the width:
  torchvision's v1.5 block), stages (3, 4, 6, 3), channels
  (64, 256, 512, 1024, 2048), as monodepth2's `resnet_encoder.py` widens
  `num_ch_enc[1:]` by 4 above 34 layers.
Each decoder takes its own encoder's channels (`depth_decoder.py`,
`pose_decoder.py`): the depth decoder's skips and the pose squeeze follow
them.

A frozen copy of the equations, written without anything of the program:
parameter names follow torchvision and the monodepth2 checkpoints
(`resnet.layer1.0.conv1`, `resnet.layer1.0.conv3` at 50,
`upconv_4_0.conv.conv`, `dispconv_0.conv`, `squeeze`, `pose_0`), so one
state dict made by the benchmark loads into both sides.

Departures from the published description, each shared with the program
under test:
- images come in NHWC in [0, 1] and are normalised as (x - 0.45) / 0.225;
- batch norm in train mode moves its running statistics by flax's rule
  (momentum 0.9, the biased batch variance), not by torch's;
- the depth decoder's reflection pad repeats a row or column of size 1.

`DepthPoseNet(precision=...)` sets how each convolution computes:
- "float32": the reference;
- "bf16": input, weight, output and the output's gradient rounded to
  bfloat16, as autocast runs a bf16 network (a look at rounding alone);
- "fp8": input and weight rounded to float8 e4m3 and the output's gradient
  to e5m2 (one scale a tensor, to the format's largest value) around a
  float32 convolution, forward and backward: the control of a configuration
  with bf16 networks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

STAGE_PLANES = (64, 128, 256, 512)
DECODER_CHANNELS = (16, 32, 64, 128, 256)
PRECISIONS = ("float32", "bf16", "fp8")


def _quantise(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to float8 `dtype` with one scale for the tensor, in x's type."""
    scale = torch.finfo(dtype).max / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3, with the identity's gradient."""
    return x + (_quantise(x.detach(), torch.float8_e4m3fn) - x).detach()


class _GradRound(torch.autograd.Function):
    """The identity forward; the gradient rounded to `dtype` on its way back."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.dtype == torch.bfloat16:
            return g.to(torch.bfloat16).to(g.dtype), None
        return _quantise(g, ctx.dtype), None


class Conv2d(nn.Conv2d):
    precision = "float32"  # set on the instances by DepthPoseNet

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            y = self._conv_forward(round_fp8(x), round_fp8(self.weight), self.bias)
            return _GradRound.apply(y, torch.float8_e5m2)
        if self.precision == "bf16":
            b = None if self.bias is None else self.bias.to(torch.bfloat16)
            y = self._conv_forward(x.to(torch.bfloat16), self.weight.to(torch.bfloat16), b)
            return _GradRound.apply(y.to(x.dtype), torch.bfloat16)
        return super().forward(x)


class BatchNorm(nn.BatchNorm2d):
    """Eval mode: running statistics.  Train mode: batch statistics, and the
    running ones move as 0.9 * running + 0.1 * batch (biased variance)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        y = y * self.weight[:, None, None] + self.bias[:, None, None]
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
            self.num_batches_tracked.add_(1)
        return y


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(Conv2d(inplanes, planes, 1, stride, bias=False),
                                            BatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, width, 1, bias=False)
        self.bn3 = BatchNorm(width)
        self.downsample = None
        if stride != 1 or inplanes != width:
            self.downsample = nn.Sequential(Conv2d(inplanes, width, 1, stride, bias=False),
                                            BatchNorm(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


# depth -> (block, blocks a stage)
RESNET_STAGES = {18: (BasicBlock, (2, 2, 2, 2)), 34: (BasicBlock, (3, 4, 6, 3)),
                 50: (Bottleneck, (3, 4, 6, 3))}


def encoder_channels(num_layers: int) -> Tuple[int, ...]:
    """The five feature maps' channels of a ResNet of `num_layers`."""
    block, _ = RESNET_STAGES[num_layers]
    return (64,) + tuple(p * block.expansion for p in STAGE_PLANES)


ENCODER_CHANNELS = encoder_channels(18)


class _ResNet(nn.Module):
    def __init__(self, num_layers: int, in_channels: int):
        super().__init__()
        if num_layers not in RESNET_STAGES:
            raise ValueError(f"no ResNet-{num_layers} here: {sorted(RESNET_STAGES)}")
        block, stages = RESNET_STAGES[num_layers]
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for i, (blocks, planes) in enumerate(zip(stages, STAGE_PLANES)):
            stride = 1 if i == 0 else 2
            layer = [block(inplanes, planes, stride)]
            inplanes = planes * block.expansion
            layer += [block(inplanes, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))


class ResNetEncoder(nn.Module):
    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        self.num_ch_enc = encoder_channels(num_layers)
        self.resnet = _ResNet(num_layers, 3 * num_input_images)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3 * images) in [0, 1] -> five NCHW feature maps."""
        r = self.resnet
        x = ((x - 0.45) / 0.225).permute(0, 3, 1, 2)
        f0 = F.relu(r.bn1(r.conv1(x)))
        x = F.max_pool2d(f0, 3, 2, 1)
        features = [f0]
        for layer in (r.layer1, r.layer2, r.layer3, r.layer4):
            x = layer(x)
            features.append(x)
        return features


def reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    if h > 1 and w > 1:
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    x = F.pad(x, (1, 1, 0, 0), mode="reflect" if w > 1 else "replicate")
    return F.pad(x, (0, 0, 1, 1), mode="reflect" if h > 1 else "replicate")


class Conv3x3(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(reflect_pad1(x))


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    def __init__(self, scales: Sequence[int] = (0, 1, 2, 3),
                 num_ch_enc: Sequence[int] = ENCODER_CHANNELS):
        super().__init__()
        self.scales = tuple(scales)
        for i in range(4, -1, -1):
            ch_in = num_ch_enc[-1] if i == 4 else DECODER_CHANNELS[i + 1]
            setattr(self, f"upconv_{i}_0", ConvBlock(ch_in, DECODER_CHANNELS[i]))
            ch_in = DECODER_CHANNELS[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            setattr(self, f"upconv_{i}_1", ConvBlock(ch_in, DECODER_CHANNELS[i]))
        for s in self.scales:
            setattr(self, f"dispconv_{s}", Conv3x3(DECODER_CHANNELS[s], 1))

    def forward(self, features: Sequence[torch.Tensor]) -> Dict[int, torch.Tensor]:
        """-> {scale: sigmoid disparity (B, H_s, W_s, 1)}."""
        out = {}
        x = features[-1]
        for i in range(4, -1, -1):
            x = getattr(self, f"upconv_{i}_0")(x)
            if i > 0:
                skip = features[i - 1]
                x = torch.cat([F.interpolate(x, size=skip.shape[2:], mode="nearest"), skip], 1)
            else:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"upconv_{i}_1")(x)
            if i in self.scales:
                out[i] = torch.sigmoid(getattr(self, f"dispconv_{i}")(x)).permute(0, 2, 3, 1)
        return out


class PoseDecoder(nn.Module):
    def __init__(self, num_ch_in: int = ENCODER_CHANNELS[-1]):
        super().__init__()
        self.squeeze = Conv2d(num_ch_in, 256, 1)
        self.pose_0 = Conv2d(256, 256, 3, 1, 1)
        self.pose_1 = Conv2d(256, 256, 3, 1, 1)
        self.pose_2 = Conv2d(256, 12, 1)

    def forward(self, feature: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage-4 feature -> (axis-angle (B, 3), translation (B, 3)) of the
        first of the two predicted frames, scaled by 0.01."""
        x = F.relu(self.squeeze(feature))
        x = F.relu(self.pose_0(x))
        x = F.relu(self.pose_1(x))
        x = 0.01 * self.pose_2(x).mean((2, 3)).reshape(-1, 2, 6)
        return x[:, 0, :3], x[:, 0, 3:]


class DepthPoseNet(nn.Module):
    """The depth encoder at `resnet` layers, the pose encoder at
    `resnet_pose` (by default the same), each decoder at its encoder's
    channels."""

    def __init__(self, scales: Sequence[int] = (0, 1, 2, 3), resnet: int = 18,
                 precision: str = "float32", resnet_pose: Optional[int] = None):
        super().__init__()
        self.depth_encoder = ResNetEncoder(resnet, 1)
        self.depth_decoder = DepthDecoder(scales, self.depth_encoder.num_ch_enc)
        self.pose_encoder = ResNetEncoder(resnet if resnet_pose is None else resnet_pose, 2)
        self.pose_decoder = PoseDecoder(self.pose_encoder.num_ch_enc[-1])
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.precision = precision
