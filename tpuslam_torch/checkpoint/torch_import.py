"""ImageNet initialisation of the encoders from a local torchvision ResNet,
and the loop-closure embedder from a local torchvision MobileNetV3-small.

Counterpart of `tpuslam/checkpoint/torch_import.py::load_imagenet_encoders`,
`init_encoders_from_imagenet` and `load_mobilenet_embedder`.  The reference starts pretraining from
encoders built with `pretrained=True`: one torchvision ResNet checkpoint
initialises both encoders, the depth encoder as it is and the 2-image pose
encoder with its stem `conv1` repeated over the stacked input channels and
divided by 2, so that activations keep their single-image magnitude.  The
classifier (`fc.*`) is dropped.  The port's encoders carry torchvision's key
names under `resnet.` (`conv3` / `bn3` in ResNet-50's Bottlenecks), so the
state dict loads without renaming.

`load_mobilenet_embedder` reads a torchvision `mobilenet_v3_small` `.pth`
(with or without a `state_dict` wrapper) into `MobileNetV3SmallEmbedder`,
whose modules carry torchvision's names; the classifier is ignored.

Only a local `.pth` is read (torchvision is not needed, nothing is
downloaded).  Reference `weights_NNN/` folders load through
`DepthPosePrediction.load_reference_checkpoint`.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

from tpuslam_torch.models.depth_pose import DepthPoseNet
from tpuslam_torch.models.embedder import MobileNetV3SmallEmbedder

MISSING_WEIGHTS = (
    "resnet_pretrained=True requires encoder_weights pointing at a local torchvision "
    "ResNet .pth (this environment has no network egress to download ImageNet weights)"
)


def imagenet_encoder_state(state: Dict[str, torch.Tensor],
                           num_input_images: int = 1) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict -> the state dict of one
    `ResNetEncoder` (`resnet.`-prefixed, no `fc.*`), its stem repeated over
    `num_input_images` stacked images and divided by their count."""
    if "state_dict" in state:
        state = state["state_dict"]
    out = {f"resnet.{k}": v.detach().float() for k, v in state.items()
           if not k.startswith("fc.")}
    if num_input_images > 1:
        conv1 = out["resnet.conv1.weight"]  # OIHW: input channels on axis 1
        out["resnet.conv1.weight"] = torch.cat([conv1] * num_input_images, 1) / num_input_images
    return out


def load_imagenet_encoders(model: DepthPoseNet, path: Path) -> None:
    """Load a torchvision ResNet `.pth` into both encoders of `model`, in
    place.  A stem whose shape does not fit, or the keys of another depth,
    raise ValueError."""
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    for net, images in (("depth_encoder", 1), ("pose_encoder", 2)):
        encoder = getattr(model, net)
        saved = imagenet_encoder_state(state, images)
        have = tuple(encoder.resnet.conv1.weight.shape)
        got = tuple(saved["resnet.conv1.weight"].shape)
        if have != got:
            raise ValueError(f"{net} conv1 shape mismatch: model {have} vs checkpoint {got} "
                             "— wrong ResNet depth or stem width?")
        current = encoder.state_dict()
        # torchvision checkpoints before v0.4 lack num_batches_tracked
        saved.update({k: v for k, v in current.items()
                      if k.endswith("num_batches_tracked") and k not in saved})
        if set(saved) != set(current):
            raise ValueError(f"{net} is a ResNet-{encoder.num_layers}: the checkpoint lacks "
                             f"{sorted(set(current) - set(saved))[:3]} and has "
                             f"{sorted(set(saved) - set(current))[:3]} besides — another "
                             "ResNet depth?")
        encoder.load_state_dict(saved)


def init_encoders_from_imagenet(model: DepthPoseNet, encoder_weights: Optional[Path],
                                required: bool = False) -> None:
    """ImageNet encoders from `encoder_weights`; without a file a no-op,
    unless `required` (the `resnet_pretrained` option), which raises."""
    if encoder_weights is None:
        if required:
            raise FileNotFoundError(MISSING_WEIGHTS)
        return
    load_imagenet_encoders(model, encoder_weights)


def load_mobilenet_embedder(path: Path, device="cpu") -> MobileNetV3SmallEmbedder:
    """A torchvision `mobilenet_v3_small` `.pth` -> the embedder on `device`,
    in eval mode.  Every key of the backbone must be there (torchvision
    checkpoints before v0.4 lack `num_batches_tracked`); `classifier.*` is
    ignored, and any other key raises KeyError."""
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    model = MobileNetV3SmallEmbedder()
    result = model.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    unexpected = [k for k in result.unexpected_keys if not k.startswith("classifier.")]
    if missing or unexpected:
        raise KeyError(f"not a mobilenet_v3_small state dict: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    return model.to(device).eval()
