"""The depth + pose networks bundled into one module.

Counterpart of `tpuslam/models/depth_pose.py`: the reference's four networks
{depth_encoder, depth_decoder, pose_encoder, pose_decoder}, with the encoder
and decoder halves exposed separately so online adaptation can run the frozen
encoders once per frame and iterate over the decoders only.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from tpuslam_torch.models.decoders import DepthDecoder, PoseDecoder
from tpuslam_torch.models.resnet import ResNetEncoder


class DepthPoseNet(nn.Module):
    def __init__(self, resnet_depth: int = 18, resnet_pose: int = 18,
                 scales: Tuple[int, ...] = (0, 1, 2, 3)):
        super().__init__()
        self.depth_encoder = ResNetEncoder(resnet_depth, num_input_images=1)
        self.depth_decoder = DepthDecoder(ResNetEncoder.num_ch_encoder, scales)
        self.pose_encoder = ResNetEncoder(resnet_pose, num_input_images=2)
        self.pose_decoder = PoseDecoder(num_frames_to_predict_for=2)

    def depth_encode(self, image: torch.Tensor):
        """image (B, H, W, 3) -> list of 5 NCHW encoder feature maps."""
        return self.depth_encoder(image)

    def depth_decode(self, features):
        """Encoder feature pyramid -> {('disp', s): (B, H_s, W_s, 1)}."""
        return self.depth_decoder(features)

    def pose_encode(self, image_pair: torch.Tensor):
        """image_pair (B, H, W, 6) [earlier ++ later frame] -> 5 feature maps."""
        return self.pose_encoder(image_pair)

    def pose_decode(self, feature: torch.Tensor):
        """Stage-4 pose feature -> (axis_angle (B, 3), translation (B, 3)) of
        the first predicted frame."""
        axis_angle, translation = self.pose_decoder(feature)
        return axis_angle[:, 0], translation[:, 0]


def init_depth_pose(
    seed: int = 0,
    *,
    resnet_depth: int = 18,
    resnet_pose: int = 18,
    scales: Tuple[int, ...] = (0, 1, 2, 3),
    device="cuda",
) -> DepthPoseNet:
    """Build the networks with random weights drawn from `seed`.

    Conv kernels are LeCun-normal (variance 1 / fan_in) with zero biases and
    BatchNorm starts at identity statistics, the JAX package's flax defaults.
    The model is in eval mode: BN uses running statistics, as online
    adaptation requires.
    """
    from tpuslam_torch import resolve_device

    device = resolve_device(device)
    model = DepthPoseNet(resnet_depth, resnet_pose, scales)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                w = rng.standard_normal(m.weight.shape, dtype=np.float32)
                m.weight.copy_(torch.from_numpy(w / np.sqrt(fan_in, dtype=np.float32)))
                if m.bias is not None:
                    m.bias.zero_()
    return model.to(device).eval()


def l2_normalize(features: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise so inner products become cosine similarities."""
    norm = torch.linalg.vector_norm(features, dim=dim, keepdim=True)
    return features / torch.clamp_min(norm, eps)
