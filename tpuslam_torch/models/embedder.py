"""MobileNetV3-small loop-closure embedder.

Counterpart of `tpuslam/models/embedder.py::MobileNetV3SmallEmbedder`: the
reference's loop-closure encoder, a torchvision `mobilenet_v3_small`
truncated at its flatten node.  NHWC images in [0, 1] are normalised with
the ImageNet mean and standard deviation, go through the stem, the eleven
inverted residuals of `V3_SMALL` (squeeze-excite and hard-swish where the
spec says so) and the 576-channel head, and are averaged over the image:
(B, 576) in float32, not normalised (`l2_normalize` does that).

The modules carry torchvision's names (`features.0.{0,1}` the stem,
`features.{i}.block.{j}` the sub-layers of block i in the order [expand?,
depthwise, squeeze-excite?, project], `features.12.{0,1}` the head), so a
torchvision state dict loads with `load_state_dict(strict=False)`, which
ignores only its `classifier.*`.  Batch norm takes eps 1e-3.  `Slam` never
trains the embedder: it runs in eval mode on its running statistics, in full
float32 (TF32 off), on the device of its caller's tensors.

The convolutions, the depthwise ones included, are cuDNN's: the JAX package
runs this network in XLA, not in a Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from tpuslam_torch import full_fp32
from tpuslam_torch.models.depth_pose import l2_normalize

__all__ = ["MobileNetV3SmallEmbedder", "V3_SMALL", "init_mobilenet_embedder", "l2_normalize"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-3  # torchvision's mobilenet batch norm

# (kernel, expanded, out, use_se, use_hs, stride): mobilenet_v3_small
V3_SMALL = (
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
)
STEM_CHANNELS = 16
NUM_FEATURES = 576


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


class _Act(nn.Module):
    def __init__(self, hard: bool):
        super().__init__()
        self.hard = hard

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hard_swish(x) if self.hard else F.relu(x)


class _ConvBN(nn.Sequential):
    """torchvision's `Conv2dNormActivation`: conv (no bias), batch norm and
    the activation (none for the projection)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
                 act=None):
        layers = [nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False),
                  nn.BatchNorm2d(cout, eps=BN_EPS)]
        if act is not None:
            layers.append(_Act(act))
        super().__init__(*layers)


class _SqueezeExcite(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        squeeze = make_divisible(channels // 4)
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * hard_sigmoid(self.fc2(s))


class _InvertedResidual(nn.Module):
    def __init__(self, cin: int, kernel: int, expanded: int, out: int, use_se: bool,
                 use_hs: bool, stride: int):
        super().__init__()
        layers = []
        if expanded != cin:
            layers.append(_ConvBN(cin, expanded, 1, act=use_hs))
        layers.append(_ConvBN(expanded, expanded, kernel, stride, groups=expanded, act=use_hs))
        if use_se:
            layers.append(_SqueezeExcite(expanded))
        layers.append(_ConvBN(expanded, out, 1))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return y + x if self.residual else y


class MobileNetV3SmallEmbedder(nn.Module):
    """MobileNetV3-small backbone -> global mean -> (B, 576) embedding."""

    num_features = NUM_FEATURES

    def __init__(self):
        super().__init__()
        features = [_ConvBN(3, STEM_CHANNELS, 3, 2, act=True)]
        cin = STEM_CHANNELS
        for cfg in V3_SMALL:
            features.append(_InvertedResidual(cin, *cfg))
            cin = cfg[2]
        features.append(_ConvBN(cin, NUM_FEATURES, 1, act=True))
        self.features = nn.Sequential(*features)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) in [0, 1] -> (B, 576), not normalised."""
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        return self.features(x).float().mean((2, 3))

    @torch.no_grad()
    @full_fp32()
    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """The L2-normalised embedding of NHWC images, in eval mode, in full
        float32: what `Slam` stores in its loop-closure index."""
        return l2_normalize(self(images))


def init_mobilenet_embedder(seed: int = 1, device="cpu") -> MobileNetV3SmallEmbedder:
    """A randomly initialised embedder, drawn from a numpy generator seeded
    with `seed`: convolutions normal with variance 1 / fan-in (flax's
    default, which the JAX package's random embedder has), zero biases, unit
    batch-norm scales and statistics."""
    rng = np.random.default_rng(seed)
    model = MobileNetV3SmallEmbedder()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = rng.standard_normal(m.weight.shape, dtype=np.float32)
                m.weight.copy_(torch.from_numpy(w / np.float32(np.sqrt(fan_in))))
                if m.bias is not None:
                    m.bias.zero_()
    return model.to(device)
