"""The dual-network and CoVIO async modes of the PyTorch port against the
JAX package.

Both `Slam`s load one checkpoint that the JAX package wrote (through
`load_weights_folder`), run the synthetic world at 64 x 192 with float32
networks and float32 warp storage, and are compared frame by frame.  The
identity tie-break noise is off on both sides: the port's generators are
None, and the JAX step's `total_loss` is called with `rng=None` (a patch
in this file; the two packages draw the noise from different generators,
and at near-ties Adam's normalised first steps carry it into the weights at
~1e-4).  The JAX package adopts an async update when `_tree_ready` says its
arrays are ready, which depends on timing on the CPU: here it is pinned to true, the
schedule the port gives on the CPU (each update adopted at the next frame).
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import tpuslam.posegraph.native as jax_native
from tpuslam.checkpoint.io import save_checkpoint as jax_save_checkpoint
from tpuslam.config import parse_config as jax_parse_config
from tpuslam.models import init_depth_pose as jax_init
from tpuslam.slam import Slam as JaxSlam
from tpuslam_torch.checkpoint.from_jax import jax_to_state_dict
from tpuslam_torch.config import parse_config
from tpuslam_torch.slam import Slam
from tpuslam_torch.train.state import clone_train_state
from tpuslam_torch.train.steps import consolidate_step, consolidate_step_async

torch.set_num_threads(1)

YAML = """
Dataset:
  dataset: Synthetic
  height: 64
  width: 192
  num_frames: {frames}
  trajectory: loop
DepthPosePrediction:
  batch_size: 3
  scales: [0, 1]
  dtype: float32
  pallas_bf16_out: false
  log_path: {log}
  load_weights_folder: {weights}
ReplayBuffer:
  max_buffer_size: 8
  similarity_threshold: 0.999
LoopClosureDetection:
  detection_threshold: 0.5
  id_threshold: 3
Slam:
  adaptation: true
  adaptation_epochs: {epochs}
  min_distance: 0.0
  do_loop_closures: {loops}
  keyframe_frequency: 2
  lc_distance_poses: 2
  pipeline_depth: {depth}
  plot_frequency: 0
  use_expert: {expert}
  generalist_interval: 2
  async_adaptation: {async_}
"""

PACKED_TOL = 1e-3  # the adapting Slam's tolerance of test_torch_port_slam.py
WEIGHT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library(tmp_path_factory):
    """The JAX Slam's solves build the JAX package's C++ solver at first
    use; here into a temporary directory (as test_torch_port_loopclosure.py
    does)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", tmp_path_factory.mktemp("native") / "libposegraph.so")
        mp.setattr(jax_native, "_lib", None)
        yield


@pytest.fixture(autouse=True)
def _jax_noise_off(monkeypatch):
    """The JAX steps call `total_loss` without tie-break noise."""
    jax_steps = importlib.import_module("tpuslam.train.steps")
    total_loss = jax_steps.total_loss
    monkeypatch.setattr(jax_steps, "total_loss",
                        lambda *args, **kwargs: total_loss(*args, **{**kwargs, "rng": None}))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A checkpoint folder written by the JAX package's `save_checkpoint`."""
    _, variables = jax_init(jax.random.PRNGKey(3), height=64, width=192, scales=(0, 1))
    return jax_save_checkpoint(tmp_path_factory.mktemp("ckpt"), 0, variables["params"],
                               variables["batch_stats"])


def _slams(tmp_path, weights, frames=6, expert=False, async_=False, loops=False, depth=0,
           epochs=2):
    path = tmp_path / "slam.yaml"
    path.write_text(YAML.format(
        frames=frames, log=tmp_path / "log", weights=weights, loops=str(loops).lower(),
        depth=depth, expert=str(expert).lower(), async_=str(async_).lower(), epochs=epochs))
    jslam = JaxSlam(jax_parse_config(path))
    slam = Slam(parse_config(path), device="cpu")
    slam.state.rng = None
    if slam.generalist_state is not None:
        slam.generalist_state.rng = None
    return jslam, slam


def _record_packed(slam):
    """Keep each full frame's packed readback as `_dispatch` makes it."""
    packed, dispatch = [], slam._dispatch

    def kept(sample):
        entry = dispatch(sample)
        if entry["kind"] == "full":
            v = entry["outputs"][("retire_packed",)]
            v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            packed.append(v.astype(np.float64))
        return entry

    slam._dispatch = kept
    return packed


def _run_both(jslam, slam, frames):
    jpacked, packed = _record_packed(jslam), _record_packed(slam)
    jslam.run(max_steps=frames, progress=False)
    slam.run(max_steps=frames, progress=False)
    assert len(packed) == len(jpacked) == frames
    return np.stack(jpacked), np.stack(packed)


def _decoders(state):
    return {k: v.numpy() for k, v in state.model.state_dict().items() if "decoder" in k}


def _jax_decoders(state):
    tree = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
    return {k: v for k, v in jax_to_state_dict(*tree).items() if "decoder" in k}


def _weights_rel(got, want):
    """All decoder parameters as one vector: relative difference (norm)."""
    assert got.keys() == want.keys()
    g = np.concatenate([got[k].ravel() for k in sorted(got)]).astype(np.float64)
    w = np.concatenate([want[k].ravel() for k in sorted(got)]).astype(np.float64)
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _assert_weights_close(got, want):
    """Within 1e-4 relative, as test_torch_port_adapt.py holds them: Adam's
    first steps move an element whose gradient is near zero by ~lr
    whichever its sign, so single elements differ by up to a few lr where
    the two packages round apart."""
    rel = _weights_rel(got, want)
    print(f"decoder weights: relative difference {rel:.3g}")
    assert rel <= WEIGHT_TOL


def _assert_same_frames(jslam, slam, jpacked, packed):
    assert slam.replay_composition == jslam.replay_composition
    np.testing.assert_allclose(packed, jpacked, atol=PACKED_TOL, rtol=PACKED_TOL)
    assert np.isfinite(packed).all()
    assert slam.pose_graph.vertex_ids == jslam.pose_graph.vertex_ids
    np.testing.assert_allclose(np.stack(slam.pose_graph.get_all_poses()),
                               np.stack(jslam.pose_graph.get_all_poses()), atol=PACKED_TOL)


def test_dual_network_matches(tmp_path, weights):
    """`use_expert` with `generalist_interval: 2` over 6 frames (K = 1): per-frame
    packed readbacks within 1e-3, the generalist's decoder weights within
    1e-4 relative of the JAX generalist's (consolidations at frames 2, 4 and 6, on
    replay draws made in the same order), and `reset_expert_from_generalist`
    makes the expert's networks equal to the generalist's, with a fresh
    optimizer."""
    jslam, slam = _slams(tmp_path, weights, expert=True, epochs=1)
    initial = _decoders(slam.state)
    jpacked, packed = _run_both(jslam, slam, 6)
    _assert_same_frames(jslam, slam, jpacked, packed)
    assert slam.generalist_state.step == jslam.generalist_state.step == 3
    _assert_weights_close(_decoders(slam.generalist_state), _jax_decoders(jslam.generalist_state))
    assert any(not np.array_equal(v, initial[k])
               for k, v in _decoders(slam.generalist_state).items())
    slam.reset_expert_from_generalist()
    assert slam.state.model is not slam.generalist_state.model
    assert slam.state.model.depth_encoder is slam.generalist_state.model.depth_encoder
    torch.testing.assert_close(slam.state.model.state_dict(),
                               slam.generalist_state.model.state_dict(), rtol=0, atol=0)
    assert not slam.state.optimizer.state and slam.state.step == 0


@pytest.mark.parametrize("loops, depth", [(False, 0), (True, 2)])
def test_async_matches(tmp_path, weights, monkeypatch, loops, depth):
    """`async_adaptation` (K = 1), with the JAX `_tree_ready` pinned to
    true: the same adoption schedule (`launched` / `adopted` counts, every
    update adopted at the next frame and the last by `finish_async`, which
    `run` ends in), per-frame packed readbacks within 1e-3, and after 3
    frames the serving decoders within 1e-4 relative of the JAX package's.
    The three updates move them by more than 1e-3 relative (checked), so
    an update adopted a frame early or late shows; later frames are not
    held to 1e-4, because the two packages' rounding grows through Adam's
    steps (in the synchronous loop as well).  Also with `pipeline_depth: 2` and loop
    closure on over 6 frames (the loop pose predicted with the serving
    weights)."""
    monkeypatch.setattr(importlib.import_module("tpuslam.slam.slam"), "_tree_ready",
                        lambda state: True)
    frames = 6 if loops else 3
    jslam, slam = _slams(tmp_path, weights, frames=frames, async_=True, loops=loops,
                         depth=depth, epochs=1)
    initial = _decoders(slam.state)
    jpacked, packed = _record_packed(jslam), _record_packed(slam)
    for s in (jslam, slam):
        s.run(max_steps=3, progress=False)
    assert slam._pending is None and jslam._pending_state is None
    assert slam.state.step == int(jslam.state.step) == 3
    _assert_weights_close(_decoders(slam.state), _jax_decoders(jslam.state))
    assert _weights_rel(_decoders(slam.state), initial) > 1e-3
    for s in (jslam, slam):
        s.run(max_steps=frames - 3, progress=False)
    assert len(packed) == len(jpacked) == frames
    _assert_same_frames(jslam, slam, np.stack(jpacked), np.stack(packed))
    assert (slam.async_updates_launched, slam.async_updates_adopted) == (
        jslam.async_updates_launched, jslam.async_updates_adopted) == (frames, frames)
    if loops:
        assert [(d["step"], d["lc_id"]) for d in slam.lc_edge_diagnostics] == [
            (d["step"], d["lc_id"]) for d in jslam.lc_edge_diagnostics]
        assert slam.pose_graph.num_loop_closures >= 1


def test_consolidate_async_leaves_the_source_untouched(tmp_path, weights):
    """`consolidate_step_async` updates a clone: the source state's
    networks, Adam state and generator are bit for bit as before, and the
    clone equals `consolidate_step` run on `clone_train_state` of the
    source (the CPU runs both synchronously, the event is None)."""
    _, slam = _slams(tmp_path, weights)
    slam.run(max_steps=2, progress=False)  # an Adam state to copy
    src = slam.state
    src.rng = torch.Generator().manual_seed(5)
    before = {k: v.clone() for k, v in src.model.state_dict().items()}
    opt_before = {id(p): {k: v.clone() for k, v in st.items()}
                  for p, st in src.optimizer.state.items()}
    rng_before = src.rng.get_state()
    batch = slam._training_batch(slam._sample_to_batch(slam.dataset[2]), slam.dataset[2])
    clone, event = consolidate_step_async(src, slam.loss_cfg, batch, num_steps=2)
    assert event is None and clone.step == src.step + 1
    torch.testing.assert_close(src.model.state_dict(), before, rtol=0, atol=0)
    for p, st in src.optimizer.state.items():
        torch.testing.assert_close(dict(st), opt_before[id(p)], rtol=0, atol=0)
    assert torch.equal(src.rng.get_state(), rng_before)
    assert not torch.equal(clone.rng.get_state(), rng_before)
    same = clone_train_state(src)
    consolidate_step(same, slam.loss_cfg, batch, num_steps=2)
    torch.testing.assert_close(clone.model.state_dict(), same.model.state_dict(), rtol=0, atol=0)
    clone_params = {id(p) for p in clone.model.parameters()}
    assert all(id(p) in clone_params for g in clone.optimizer.param_groups for p in g["params"])
    assert clone.model.pose_encoder is src.model.pose_encoder
    with pytest.raises(NotImplementedError, match="training path"):
        consolidate_step(same, slam.loss_cfg, batch, num_steps=1, freeze_encoder=False)
