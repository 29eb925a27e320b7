"""ResNet-18/34/50 feature-pyramid encoder.

Counterpart of `tpuslam/models/resnet.py`: input normalisation
(x - 0.45) / 0.225 in the forward pass, five feature stages, and a
multi-image stem (conv1 over 3 * num_input_images channels) for the pose
network.  ResNet-18 and 34 stack BasicBlocks, channels
(64, 64, 128, 256, 512); ResNet-50 stacks torchvision's v1.5 Bottlenecks
(1x1, 3x3 with the stride, 1x1 to four times the width), channels
(64, 256, 512, 1024, 2048), as monodepth2's `--num_layers 50` (the JAX
package holds 18 and 34 only).  Modules carry the monodepth2 / torchvision
names (`resnet.conv1`, `resnet.layer1.0.conv1`, `...conv3` at 50,
`...downsample.0`), so reference `.pth` state dicts load directly.

Takes NHWC images and returns NCHW feature maps in float32, or float64 for a
float64 input (the tensors are channels-last in memory, which is cuDNN's
fast layout).

Batch norm in train mode (`model.train()`, pretraining) normalises with the
batch statistics, as torch does, but moves its running statistics by
flax's rule, which differs from `nn.BatchNorm2d`'s: the running variance
takes the biased batch variance (torch takes the unbiased one, n / (n - 1)
larger, up to 4 / 3 on small maps), computed in float32 under autocast.
With a `process_group` set (data-parallel pretraining,
`tpuslam_torch.parallel`), train mode normalises with the statistics of the
batch of every rank of the group, and the running statistics move by the
same rule with the global mean and biased variance.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as F

from tpuslam_torch import at_least_f32

STAGE_PLANES = (64, 128, 256, 512)


class _SyncBatchNorm(torch.autograd.Function):
    """Batch norm over the batches of every rank of `group` (flax's sync-BN,
    `axis_name` psums): the forward normalises with the global mean and
    biased variance, from an all-reduce of the per-channel sums and counts
    and then one of the per-channel sums of squares about that mean (two
    passes, as a single process takes them); the backward all-reduces its
    two per-channel sums, so that each rank's input gradient is the one of
    the global batch.  The scale and bias get this rank's own terms, which
    the data-parallel step averages with the other gradients.  Works in
    float32 (float64 for a float64 input); returns the output in the
    input's type, and the global mean and variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = at_least_f32(x)
        C = x.shape[1]
        sums = torch.cat([xf.sum((0, 2, 3)), xf.new_full((1,), xf.numel() // C)])
        dist.all_reduce(sums, group=group)
        n = sums[C]
        mean = sums[:C] / n
        centred = xf - mean[:, None, None]
        var = (centred * centred).sum((0, 2, 3))
        dist.all_reduce(var, group=group)
        var /= n
        invstd = torch.rsqrt(var + eps)
        xhat = centred * invstd[:, None, None]
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.n, ctx.group = n, group
        ctx.mark_non_differentiable(mean, var)
        y = xhat * weight[:, None, None] + bias[:, None, None]
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight = ctx.saved_tensors
        dyf = dy.to(xhat.dtype)
        C = xhat.shape[1]
        sums = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        grad_bias, grad_weight = sums[:C].clone(), sums[C:].clone()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xhat = sums[:C] / ctx.n, sums[C:] / ctx.n
        dx = (dyf - mean_dy[:, None, None] - xhat * mean_dy_xhat[:, None, None]) \
            * (invstd * weight)[:, None, None]
        return (dx.to(dy.dtype), grad_weight.to(weight.dtype), grad_bias.to(weight.dtype),
                None, None)


class BatchNorm(nn.BatchNorm2d):
    """flax `BatchNorm(momentum=0.9, epsilon=1e-5)`: in train mode the
    running statistics become 0.9 * running + 0.1 * batch statistic, with
    the biased variance; eval mode is `nn.BatchNorm2d`'s.  With
    `process_group` set, the batch is that of every rank of the group."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                                self.process_group)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(at_least_f32(x), dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
            self.num_batches_tracked.add_(1)
        return y



class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False), BatchNorm(planes)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """torchvision's v1.5 bottleneck: the stride on the 3x3."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, width, 1, bias=False)
        self.bn3 = BatchNorm(width)
        self.downsample = None
        if stride != 1 or inplanes != width:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, width, 1, stride, bias=False), BatchNorm(width)
            )

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
    """The channels of the five feature maps of a ResNet of `num_layers`."""
    block, _ = RESNET_STAGES[num_layers]
    return (64,) + tuple(p * block.expansion for p in STAGE_PLANES)


class _ResNet(nn.Module):
    """The torchvision ResNet trunk without its classifier."""

    def __init__(self, num_layers: int, in_channels: int):
        super().__init__()
        if num_layers not in RESNET_STAGES:
            raise ValueError(f"Unsupported ResNet depth: {num_layers}")
        block, stages = RESNET_STAGES[num_layers]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for i, (blocks, planes) in enumerate(zip(stages, STAGE_PLANES)):
            stride = 1 if i == 0 else 2
            layer = [block(inplanes, planes, stride)]
            inplanes = planes * block.expansion
            layer += [block(inplanes, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))


class ResNetEncoder(nn.Module):
    """Five-stage feature pyramid; `num_input_images` stacks RGB channel-wise.
    `num_ch_encoder` holds the five maps' channels."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1):
        super().__init__()
        self.resnet = _ResNet(num_layers, 3 * num_input_images)
        self.num_layers = num_layers
        self.num_ch_encoder = encoder_channels(num_layers)

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
        return [at_least_f32(f) for f in features]
