"""The SLAM loop of the PyTorch port against the JAX package's.

One YAML file drives both packages (each parses it with its own copy of the
config parser).  The port's networks get the JAX Slam's initial weights via
`load_jax_variables`; both run 4 frames of the synthetic world at 64 x 192,
float32 networks, float32 warp storage.
"""
import numpy as np
import pytest
import torch

from tpuslam.config import parse_config as jax_parse_config
from tpuslam.slam import Slam as JaxSlam
from tpuslam_torch.checkpoint.from_jax import load_jax_variables
from tpuslam_torch.config import parse_config
from tpuslam_torch.slam import Slam

torch.set_num_threads(1)

FRAMES = 4

YAML = """
Dataset:
  dataset: Synthetic
  height: 64
  width: 192
  num_frames: 8
DepthPosePrediction:
  batch_size: 3
  dtype: float32
  pallas_bf16_out: false
  log_path: {log}
ReplayBuffer:
  max_buffer_size: 8
  similarity_threshold: 0.999
Slam:
  adaptation: {adaptation}
  adaptation_epochs: 2
  min_distance: 0.0
  do_loop_closures: false
  plot_frequency: 0
"""


def _packed(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _run(slam, n):
    """`Slam.step` n times, keeping each frame's packed readback."""
    packed = []
    for _ in range(n):
        slam.current_step += 1
        entry = slam._dispatch(slam.dataset[slam.current_step - 1])
        packed.append(_packed(entry["outputs"][("retire_packed",)]).astype(np.float64))
        slam._retire(entry)
    return np.stack(packed)


def _pair(tmp_path, adaptation):
    path = tmp_path / "slam.yaml"
    path.write_text(YAML.format(log=tmp_path / "log", adaptation=str(adaptation).lower()))
    jslam = JaxSlam(jax_parse_config(path))
    slam = Slam(parse_config(path), device="cpu")
    load_jax_variables(slam.model, jslam.state.params, jslam.state.batch_stats)
    return jslam, _run(jslam, FRAMES), slam, _run(slam, FRAMES)


def _poses(slam):
    return np.stack(slam.pose_graph.get_all_poses())


def test_slam_inference_matches(tmp_path):
    """`adaptation: false`: per-frame packed readbacks (pose, embedding,
    losses) and the trajectory within 1e-4."""
    jslam, jpacked, slam, packed = _pair(tmp_path, False)
    np.testing.assert_allclose(packed, jpacked, atol=1e-4, rtol=1e-4)
    assert slam.pose_graph.vertex_ids == jslam.pose_graph.vertex_ids == list(range(FRAMES + 1))
    np.testing.assert_allclose(_poses(slam), _poses(jslam), atol=1e-4)
    np.testing.assert_allclose(slam.depth_loss, jslam.depth_loss, rtol=1e-4)


def test_slam_adaptation_matches(tmp_path):
    """`adaptation: true` (K = 2, batch 3 with replay): the replay buffer
    admits and draws the same frames; losses, packed readbacks and the
    trajectory agree within 1e-3.  The JAX step adds identity tie-break
    noise from jax.random, which the port draws from a torch.Generator
    instead; it moves the gradients only at min-reprojection near-ties,
    which Adam's normalised steps carry into the weights at ~1e-5."""
    jslam, jpacked, slam, packed = _pair(tmp_path, True)
    assert slam.replay_composition == jslam.replay_composition
    assert slam.replay_buffer.index.ids.tolist() == jslam.replay_buffer.index.ids.tolist()
    np.testing.assert_allclose(packed, jpacked, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(slam.depth_loss, jslam.depth_loss, rtol=1e-3)
    np.testing.assert_allclose(slam.velocity_loss, jslam.velocity_loss, rtol=1e-3)
    np.testing.assert_allclose(_poses(slam), _poses(jslam), atol=1e-3)
    assert np.isfinite(packed).all()
