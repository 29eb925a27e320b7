"""`DepthPosePrediction` of the PyTorch port against the JAX package's.

Both facades are built at 64 x 192 (float32 networks, `pallas_fused_grad:
false`, batch 2) and the port's networks take the JAX package's weights
through `load_jax_variables`; the same synthetic frames go to both.  At
64 x 192 (W < 384) the JAX package runs its f32 sampler and the port its
kernels' plain versions, with f32 storage.  A reference checkpoint folder
written from the port's networks loads on both sides to the same depth.
"""
import numpy as np
import pytest
import torch

import jax

from tpuslam.config.schema import DatasetConfig as JaxDatasetConfig
from tpuslam.config.schema import DepthPoseConfig as JaxDepthPoseConfig
from tpuslam.predictor import DepthPosePrediction as JaxPrediction
from tpuslam.train import concat_batches as jax_concat
from tpuslam.train import make_frame_batch as jax_batch
from tpuslam_torch.checkpoint.from_jax import load_jax_variables
from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.predictor import DepthPosePrediction
from tpuslam_torch.train.batch import concat_batches, make_frame_batch

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:The model has not been trained yet")

H, W = 64, 192
CONFIG = dict(batch_size=2, dtype="float32", pallas_fused_grad=False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


@pytest.fixture(scope="module")
def facades(tmp_path_factory):
    """(JAX facade, port facade with the JAX weights, synthetic dataset)."""
    log = tmp_path_factory.mktemp("log")
    jp = JaxPrediction(JaxDatasetConfig(dataset="Synthetic", height=H, width=W),
                       JaxDepthPoseConfig(log_path=log, **CONFIG))
    tp = DepthPosePrediction(DatasetConfig(dataset="Synthetic", height=H, width=W),
                             DepthPoseConfig(log_path=log, **CONFIG), device="cpu")
    load_jax_variables(tp.model, jax.tree_util.tree_map(np.asarray, jp.state.params),
                       jax.tree_util.tree_map(np.asarray, jp.state.batch_stats))
    tp.state.rng = None  # the JAX step's tie-break noise cannot be drawn here
    return jp, tp, SyntheticDataset(num_frames=4, height=H, width=W)


def test_predictions_match_jax(facades):
    """Depth maps within 1e-5 relative, poses within 1e-6 absolute (the
    network parity of test_torch_port_nets.py), and the photometric probe
    of `predict_from_images(return_loss=True)` within 1e-5 relative."""
    jp, tp, ds = facades
    s = ds[1]
    assert _rel(tp.predict_from_image(s.rgb[1]), jp.predict_from_image(s.rgb[1])) < 1e-5
    np.testing.assert_allclose(tp.predict_pose(s.rgb[0], s.rgb[1])[0],
                               jp.predict_pose(s.rgb[0], s.rgb[1])[0], atol=1e-6)
    calib = dict(return_loss=True, camera_matrix=s.K, inv_camera_matrix=np.linalg.inv(s.K),
                 relative_distance=s.rel_dist[0])
    got = tp.predict_from_images(s.rgb[0], s.rgb[1], **calib)
    want = jp.predict_from_images(s.rgb[0], s.rgb[1], **calib)
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g, w) < 1e-5
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    assert got[3].keys() == want[3].keys()
    for k in want[3]:
        assert _rel(got[3][k], want[3][k]) < 1e-5, k


def test_adapt_matches_jax(facades):
    """The eval path of `adapt` (no training batch), then one K = 2 adapt
    with a replay sample and `online_loss_weight`: losses and the packed
    readback within 1e-4 relative (the JAX step adds its 1e-5 tie-break
    noise), as test_torch_port_adapt.py holds `adapt_step`."""
    jp, tp, ds = facades
    jb = [jax_batch(s.rgb[None], s.K, s.rel_dist[None]) for s in (ds[1], ds[2])]
    tb = [make_frame_batch(s.rgb[None], s.K, s.rel_dist[None], device="cpu")
          for s in (ds[1], ds[2])]
    _, want = jp.adapt(jb[0])
    _, got = tp.adapt(tb[0])
    assert _rel(got["loss"], want["loss"]) < 1e-4
    kw = dict(steps=2, online_loss_weight=0.7)
    wout, want = jp.adapt(jb[0], jax_concat(*jb), **kw)
    gout, got = tp.adapt(tb[0], concat_batches(*tb), **kw)
    for k in ("loss", "depth_loss", "velocity_loss", "iter_losses"):
        assert _rel(got[k], want[k]) < 1e-4, k
    assert _rel(gout[("retire_packed",)], wout[("retire_packed",)]) < 1e-4


def test_reference_checkpoint_round_trip(facades, tmp_path):
    """The four reference `.pth` files, written from port networks with
    other weights (the pose encoder's keys without the `resnet.` prefix, as
    some reference checkpoints store them), load on both sides to the same
    depth and pose."""
    jp, tp, ds = facades
    other = init_depth_pose(7, device="cpu")
    for net in ("depth_encoder", "pose_encoder", "depth_decoder", "pose_decoder"):
        state = getattr(other, net).state_dict()
        if net == "pose_encoder":
            state = {k[len("resnet."):]: v for k, v in state.items()}
        torch.save(state, tmp_path / f"{net}.pth")
    jp.load_reference_checkpoint(tmp_path)
    tp.load_reference_checkpoint(tmp_path)
    assert tp.is_trained and jp.is_trained
    torch.testing.assert_close(tp.model.state_dict(), other.state_dict(), rtol=0, atol=0)
    s = ds[2]
    assert _rel(tp.predict_from_image(s.rgb[1]), jp.predict_from_image(s.rgb[1])) < 1e-5
    np.testing.assert_allclose(tp.predict_pose(s.rgb[1], s.rgb[2])[0],
                               jp.predict_pose(s.rgb[1], s.rgb[2])[0], atol=1e-6)
