"""Carry the JAX package's flax variables into the port's networks.

`load_jax_variables(model, params, batch_stats)` takes the flax `params` /
`batch_stats` trees of `tpuslam.models.DepthPoseNet` as nested dicts of numpy
arrays and copies them, in place, into a `DepthPoseNet` of this package.  Conv
kernels transpose HWIO -> OIHW; BatchNorm scale / bias / mean / var map to
weight / bias / running_mean / running_var.  The torch names are the
monodepth2 state-dict keys that `tpuslam/checkpoint/torch_import.py` reads,
so the name table below is the inverse of that importer.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tpuslam_torch.models.depth_pose import DepthPoseNet


def _resnet_keys(flax_params: Mapping, flax_stats: Mapping, prefix: str) -> Dict[str, Any]:
    """Flax ResNetEncoder subtree -> {torch key: array} under `prefix`."""
    out: Dict[str, Any] = {}

    def conv(dst: str, leaf: Mapping):
        out[f"{prefix}{dst}.weight"] = np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)

    def bn(dst: str, p: Mapping, s: Mapping):
        out[f"{prefix}{dst}.weight"] = p["scale"]
        out[f"{prefix}{dst}.bias"] = p["bias"]
        out[f"{prefix}{dst}.running_mean"] = s["mean"]
        out[f"{prefix}{dst}.running_var"] = s["var"]

    conv("conv1", flax_params["conv1"])
    bn("bn1", flax_params["bn1"], flax_stats["bn1"])
    for name, sub in flax_params.items():
        if not name.startswith("layer"):
            continue
        layer, block = name[len("layer"):].split("_")
        dst = f"layer{layer}.{block}"
        st = flax_stats[name]
        conv(f"{dst}.conv1", sub["conv1"])
        conv(f"{dst}.conv2", sub["conv2"])
        bn(f"{dst}.bn1", sub["bn1"], st["bn1"])
        bn(f"{dst}.bn2", sub["bn2"], st["bn2"])
        if "downsample_conv" in sub:
            conv(f"{dst}.downsample.0", sub["downsample_conv"])
            bn(f"{dst}.downsample.1", sub["downsample_bn"], st["downsample_bn"])
    return out


def _decoder_keys(flax_params: Mapping, prefix: str) -> Dict[str, Any]:
    """Flax DepthDecoder / PoseDecoder subtree -> {torch key: array}.

    Flax `upconv_{i}_{j}_conv` is torch `upconv_{i}_{j}.conv.conv`,
    `dispconv_{s}_conv` is `dispconv_{s}.conv`; pose convs keep their names."""
    out: Dict[str, Any] = {}
    for name, leaf in flax_params.items():
        if name.startswith("upconv_"):
            dst = name[: -len("_conv")] + ".conv.conv"
        elif name.startswith("dispconv_"):
            dst = name[: -len("_conv")] + ".conv"
        else:
            dst = name
        out[f"{prefix}{dst}.weight"] = np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)
        out[f"{prefix}{dst}.bias"] = leaf["bias"]
    return out


def jax_to_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, np.ndarray]:
    """Flax DepthPoseNet variables -> a `DepthPoseNet.state_dict()`-keyed dict."""
    out: Dict[str, Any] = {}
    for net in ("depth_encoder", "pose_encoder"):
        out.update(_resnet_keys(params[net], batch_stats[net], f"{net}.resnet."))
    for net in ("depth_decoder", "pose_decoder"):
        out.update(_decoder_keys(params[net], f"{net}."))
    return {k: np.array(v, np.float32) for k, v in out.items()}


def load_jax_variables(model: DepthPoseNet, params: Mapping, batch_stats: Mapping) -> None:
    """Copy flax variables into `model` in place (parameters keep their
    identity, so an optimizer built on them stays valid)."""
    arrays = jax_to_state_dict(params, batch_stats)
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    if set(arrays) != set(state):
        missing = sorted(set(state) - set(arrays))
        extra = sorted(set(arrays) - set(state))
        raise KeyError(f"variable trees do not match the model: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for key, value in arrays.items():
            if tuple(state[key].shape) != value.shape:
                raise ValueError(f"{key}: model {tuple(state[key].shape)} vs {value.shape}")
            state[key].copy_(torch.from_numpy(value))
