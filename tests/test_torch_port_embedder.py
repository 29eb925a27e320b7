"""The MobileNetV3-small loop-closure embedder of the PyTorch port against
the JAX package: the network, its two ways in (a torchvision `.pth` and the
JAX package's flax variables), `l2_normalize`, and both packages' `Slam`
with `embedder: mobilenet` on the synthetic world's closed loop at 64 x 192
(float32 networks, float32 warp storage, the port's networks carrying the
JAX Slam's initial weights, both embedders reading one `.pth`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpuslam.posegraph.native as jax_native
from tpuslam.checkpoint.torch_import import load_mobilenet_embedder as jax_load_mobilenet
from tpuslam.config import parse_config as jax_parse_config
from tpuslam.models.embedder import MobileNetV3SmallEmbedder as JaxEmbedder
from tpuslam.models.embedder import l2_normalize as jax_l2_normalize
from tpuslam.slam import Slam as JaxSlam
from tpuslam_torch.checkpoint.from_jax import load_jax_variables, mobilenet_state_dict
from tpuslam_torch.checkpoint.torch_import import load_mobilenet_embedder
from tpuslam_torch.config import parse_config
from tpuslam_torch.models.embedder import MobileNetV3SmallEmbedder, l2_normalize
from tpuslam_torch.slam import Slam

torch.set_num_threads(1)

H, W = 64, 192
THRESHOLD = 0.5  # the random embedders' similarities sit at 0.9-1.0

YAML = """
Dataset:
  dataset: Synthetic
  height: 64
  width: 192
  num_frames: 12
  trajectory: loop
DepthPosePrediction:
  batch_size: 3
  scales: [0, 1]
  dtype: float32
  pallas_bf16_out: false
  log_path: {log}
ReplayBuffer:
  max_buffer_size: 8
  similarity_threshold: 0.999
LoopClosureDetection:
  detection_threshold: {threshold}
  id_threshold: 3
  embedder: mobilenet
  embedder_weights: {weights}
Slam:
  adaptation: {adaptation}
  adaptation_epochs: 2
  min_distance: 0.0
  do_loop_closures: true
  keyframe_frequency: 2
  lc_distance_poses: 2
  pipeline_depth: {depth}
  plot_frequency: 0
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library(tmp_path_factory):
    """The JAX Slam's solves build the JAX package's C++ solver into a
    temporary directory, not into `native/`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", tmp_path_factory.mktemp("native") / "libposegraph.so")
        mp.setattr(jax_native, "_lib", None)
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _torchvision_state(seed=0):
    """A torchvision-keyed `mobilenet_v3_small` state dict drawn from a
    numpy seed: convolutions with variance 2 / fan-in, batch norms near
    the identity with running statistics of a few tenths, biases small,
    and the `classifier.*` keys a torchvision checkpoint carries."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in MobileNetV3SmallEmbedder().state_dict().items():
        if k.endswith("num_batches_tracked"):
            state[k] = torch.tensor(7)
            continue
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            x = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean") or k.endswith("bias"):
            x = rng.normal(scale=0.1, size=shape)
        elif len(shape) == 1:  # batch-norm scale
            x = rng.uniform(0.8, 1.2, shape)
        else:
            x = rng.normal(scale=np.sqrt(2.0 / np.prod(shape[1:])), size=shape)
        state[k] = torch.from_numpy(x.astype(np.float32))
    state["classifier.0.weight"] = torch.from_numpy(rng.normal(size=(1024, 576)).astype(np.float32))
    state["classifier.0.bias"] = torch.zeros(1024)
    return state


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("mobilenet") / "mobilenet_v3_small.pth"
    torch.save(_torchvision_state(), path)
    return path


def _images(n=3, seed=1):
    return np.random.default_rng(seed).uniform(size=(n, H, W, 3)).astype(np.float32)


def test_embedder_from_torchvision_checkpoint_matches_jax(weights, tmp_path):
    """One torchvision `.pth` read by both packages' loaders (the port's
    with and without a `state_dict` wrapper): 576-d outputs within 1e-4
    relative, `l2_normalize` within 1e-6; a state dict of another network
    raises KeyError."""
    x = _images()
    want = np.asarray(JaxEmbedder().apply(jax_load_mobilenet(weights), jnp.asarray(x)))
    assert want.shape == (3, 576) and np.abs(want).max() > 1e-2
    wrapped = tmp_path / "wrapped.pth"
    torch.save({"state_dict": torch.load(weights)}, wrapped)
    for path in (weights, wrapped):
        model = load_mobilenet_embedder(path)
        assert not model.training
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and _rel(got, want) < 1e-4
        np.testing.assert_allclose(model.embed(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_l2_normalize(jnp.asarray(want))), atol=1e-6)
    np.testing.assert_allclose(l2_normalize(torch.tensor(want)).numpy(),
                               np.asarray(jax_l2_normalize(jnp.asarray(want))), atol=1e-6)
    state = _torchvision_state()
    state["features.13.0.weight"] = torch.zeros(1)
    torch.save(state, tmp_path / "other.pth")
    with pytest.raises(KeyError, match="features.13.0.weight"):
        load_mobilenet_embedder(tmp_path / "other.pth")


def test_embedder_from_flax_variables_matches_jax():
    """The JAX embedder's own initialisation carried over by
    `mobilenet_state_dict`: every torchvision key filled, outputs within
    1e-4 relative."""
    variables = JaxEmbedder().init(jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    state = mobilenet_state_dict(variables["params"], variables["batch_stats"])
    model = MobileNetV3SmallEmbedder()
    assert set(state) == {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=False)
    x = _images(seed=2)
    want = np.asarray(JaxEmbedder().apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < 1e-4


def _slams(tmp_path, weights, adaptation, depth):
    path = tmp_path / "slam.yaml"
    path.write_text(YAML.format(log=tmp_path / "log", threshold=THRESHOLD, weights=weights,
                                adaptation=str(adaptation).lower(), depth=depth))
    jslam = JaxSlam(jax_parse_config(path))
    slam = Slam(parse_config(path), device="cpu")
    load_jax_variables(slam.model, jslam.state.params, jslam.state.batch_stats)
    return jslam, slam


def _log_searches(det):
    """Record the frame and the candidates' similarities of every search."""
    log, search = [], det.search

    def logged(frame_id):
        sims, ids = det.index.search(det.index.reconstruct(frame_id)[None],
                                     min(100, det.index.ntotal))
        ok = (ids[0] >= 0) & (np.abs(ids[0] - frame_id) > det.id_threshold)
        log.append((frame_id, sims[0][ok]))
        return search(frame_id)

    det.search = logged
    return log


def _clear_of_threshold(log):
    sims = np.concatenate([s for _, s in log])
    assert len(sims) and np.abs(sims - THRESHOLD).min() > 1e-3, sims


def _edges(slam):
    return [(d["step"], d["lc_id"]) for d in slam.lc_edge_diagnostics]


def _index(slam):
    index = slam.loop_closure_detection.index
    return np.stack([index.reconstruct(i) for i in range(1, 13)])


def test_slam_mobilenet_inference_matches_jax(tmp_path, weights, capsys):
    """`adaptation: false` on a 12-frame loop: the same searches, the same
    loop edges (at least one), every frame's 576-d embedding in the index
    within 1e-5 (they are L2-normalised), poses after the solves within
    1e-4; the embedder is loaded from the file, with the JAX package's
    line."""
    jslam, slam = _slams(tmp_path, weights, adaptation=False, depth=0)
    out = capsys.readouterr().out
    assert out.count(f"slam: loaded mobilenet embedder from {weights}") == 2
    jlog, log = (_log_searches(s.loop_closure_detection) for s in (jslam, slam))
    jslam.run(max_steps=12, progress=False)
    slam.run(max_steps=12, progress=False)
    _clear_of_threshold(jlog + log)
    assert [f for f, _ in log] == [f for f, _ in jlog]
    assert _edges(slam) == _edges(jslam) and slam.pose_graph.num_loop_closures >= 1
    got, want = _index(slam), _index(jslam)
    assert got.shape == (12, 576)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(np.stack(slam.pose_graph.get_all_poses()),
                               np.stack(jslam.pose_graph.get_all_poses()), atol=1e-4)


def test_slam_mobilenet_adapting_pipelined_matches_jax(tmp_path, weights):
    """Adaptation (K = 2, batch 3 with replay) with `pipeline_depth: 2`:
    the embedding of each frame is made at its dispatch on its own image
    and read at its retire, so the searches and the loop edges are those of
    the JAX package (whose embedder is frozen too, so adaptation does not
    move them; no trajectory is compared, Adam's steps amplify rounding:
    `test_torch_port_loopclosure.py`)."""
    jslam, slam = _slams(tmp_path, weights, adaptation=True, depth=2)
    jlog, log = (_log_searches(s.loop_closure_detection) for s in (jslam, slam))
    jslam.run(max_steps=12, progress=False)
    slam.run(max_steps=12, progress=False)
    assert not slam._retire_queue and slam.pose_graph.vertex_ids == list(range(13))
    _clear_of_threshold(jlog + log)
    assert [f for f, _ in log] == [f for f, _ in jlog]
    assert _edges(slam) == _edges(jslam) and slam.pose_graph.num_loop_closures >= 1
    np.testing.assert_allclose(_index(slam), _index(jslam), atol=1e-5)


def test_random_embedder_warns_as_jax(tmp_path, capsys):
    """Without `embedder_weights` (none exist in the repository) both
    packages initialise the embedder at random and print the same
    WARNING line; the index takes 576-d vectors."""
    jslam, slam = _slams(tmp_path, tmp_path / "missing.pth", adaptation=False, depth=0)
    lines = [line for line in capsys.readouterr().out.splitlines() if "WARNING" in line]
    assert len(lines) == 2 and lines[0] == lines[1]
    assert lines[0].startswith("slam: WARNING — mobilenet LC embedder is randomly initialised")
    assert slam.loop_closure_detection.index.dim == 576
    assert not slam._mobilenet.training
