"""Networks of the PyTorch port against the JAX package's flax networks.

`init_depth_pose(..., dtype=float32)` variables, with random BatchNorm
running statistics so the eval-mode statistics path is exercised, are carried
into the port by `load_jax_variables`; the same numpy images then go through
both.  Outputs agree within 1e-4 (float32 convolutions summed in another
order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuslam.models import DepthPoseNet as JaxNet
from tpuslam.models import init_depth_pose as jax_init
from tpuslam_torch.checkpoint.from_jax import jax_to_state_dict, load_jax_variables
from tpuslam_torch.models.depth_pose import init_depth_pose

torch.set_num_threads(1)

H, W = 64, 128


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    model, variables = jax_init(jax.random.PRNGKey(3), height=H, width=W,
                                dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])

    def perturb(path, x):
        name = str(path[-1])
        if "mean" in name:
            return rng.normal(scale=0.1, size=x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.0, size=x.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    port = init_depth_pose(1, device="cpu")
    load_jax_variables(port, params, stats)
    return model, {"params": params, "batch_stats": stats}, port


def _images(c):
    return np.random.default_rng(c).uniform(size=(2, H, W, c)).astype(np.float32)


@pytest.mark.parametrize("method,channels", [("depth_encode", 3), ("pose_encode", 6)])
def test_encoders_match(nets, method, channels):
    model, variables, port = nets
    x = _images(channels)
    want = model.apply(variables, jnp.asarray(x), method=getattr(JaxNet, method))
    with torch.no_grad():
        got = getattr(port, method)(torch.from_numpy(x))
    assert len(got) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-4, err_msg=f"stage {i}")


def test_decoders_match(nets):
    model, variables, port = nets
    x = _images(3)
    feats = model.apply(variables, jnp.asarray(x), method=JaxNet.depth_encode)
    want = model.apply(variables, feats, method=JaxNet.depth_decode)
    want_aa, want_tr = model.apply(variables, feats[-1], method=JaxNet.pose_decode)
    tfeats = [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in feats]
    with torch.no_grad():
        got = port.depth_decode(tfeats)
        aa, tr = port.pose_decode(tfeats[-1])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4,
                                   err_msg=str(k))
    np.testing.assert_allclose(aa.numpy(), np.asarray(want_aa), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(want_tr), atol=1e-6)


def test_depth_path_at_32x64(nets):
    """depth_encode -> depth_decode at 32x64, where the stage-4 map has one
    row: the decoder's reflection pad repeats it, as jnp.pad does."""
    model, variables, port = nets
    x = np.random.default_rng(5).uniform(size=(2, 32, 64, 3)).astype(np.float32)
    feats = model.apply(variables, jnp.asarray(x), method=JaxNet.depth_encode)
    assert feats[-1].shape[1:3] == (1, 2)
    want = model.apply(variables, feats, method=JaxNet.depth_decode)
    with torch.no_grad():
        got = port.depth_decode(port.depth_encode(torch.from_numpy(x)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4,
                                   err_msg=str(k))


def test_state_dict_keys_are_monodepth2_names(nets):
    """The port's state dict carries the reference checkpoint names that
    tpuslam/checkpoint/torch_import.py reads, and every key is mapped."""
    _, variables, port = nets
    keys = set(jax_to_state_dict(variables["params"], variables["batch_stats"]))
    assert {"depth_encoder.resnet.layer2.0.downsample.0.weight",
            "depth_decoder.upconv_4_0.conv.conv.weight",
            "depth_decoder.dispconv_0.conv.bias",
            "pose_encoder.resnet.conv1.weight",
            "pose_decoder.squeeze.weight"} <= keys
    assert port.pose_encoder.resnet.conv1.weight.shape == (64, 6, 7, 7)
    with pytest.raises(KeyError):
        load_jax_variables(port, {**variables["params"], "pose_decoder": {}},
                           variables["batch_stats"])
