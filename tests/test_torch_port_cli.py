"""The entry point `cli.adapt` of the PyTorch port against the JAX
package's, and pieces the entry points use: `ChainedDataset` and the pose
graph's OBJ export (`cli.rungs` is held in test_torch_port_rungs.py).

Both packages load one checkpoint that the JAX package wrote, at 64 x 192
with float32 networks; the port runs with `--device cpu`.  The identity
tie-break noise is off on both sides (the port's `make_train_state` without
a seed, the JAX step's `total_loss` with `rng=None`; patches in this file).
"""
import functools
import importlib
import re

import jax
import numpy as np
import pytest
import torch

import tpuslam.posegraph.native as jax_native
import tpuslam_torch.slam.slam as port_slam
from tpuslam.checkpoint.io import save_checkpoint as jax_save_checkpoint
from tpuslam.cli import adapt as jax_adapt
from tpuslam.data import ChainedDataset as JaxChainedDataset
from tpuslam.data import SyntheticDataset as JaxSyntheticDataset
from tpuslam.posegraph import PoseGraph as JaxPoseGraph
from tpuslam_torch.cli import adapt
from tpuslam_torch.data import ChainedDataset, SyntheticDataset, sample_to_batch
from tpuslam_torch.posegraph.graph import PoseGraph

torch.set_num_threads(1)

YAML = """
Dataset:
  dataset: Synthetic
  height: 64
  width: 192
  num_frames: 6
  trajectory: loop
DepthPosePrediction:
  batch_size: 3
  dtype: float32
  pallas_bf16_out: false
  max_depth: 80.0
  log_path: {log}
  load_weights_folder: {weights}
ReplayBuffer:
  max_buffer_size: 8
  similarity_threshold: 0.95
  load_path: {log}/replay_buffer
LoopClosureDetection:
  detection_threshold: 0.95
  id_threshold: 20
Slam:
  adaptation: true
  adaptation_epochs: 2
  min_distance: 0.0
  keyframe_frequency: 5
  lc_distance_poses: 10
  pipeline_depth: 1
  plot_frequency: 2
"""


@pytest.fixture(autouse=True)
def _no_noise(monkeypatch, tmp_path_factory):
    """No tie-break noise in either package; the JAX C++ solver built into
    a temporary directory."""
    jax_steps = importlib.import_module("tpuslam.train.steps")
    total_loss = jax_steps.total_loss
    monkeypatch.setattr(jax_steps, "total_loss",
                        lambda *args, **kwargs: total_loss(*args, **{**kwargs, "rng": None}))
    monkeypatch.setattr(port_slam, "make_train_state",
                        functools.partial(port_slam.make_train_state, seed=None))
    monkeypatch.setattr(jax_native, "_LIB_PATH",
                        tmp_path_factory.mktemp("native") / "libposegraph.so")
    monkeypatch.setattr(jax_native, "_lib", None)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A checkpoint folder written by the JAX package's `save_checkpoint`."""
    from tpuslam.models import init_depth_pose as jax_init

    _, variables = jax_init(jax.random.PRNGKey(3), height=64, width=192)
    return jax_save_checkpoint(tmp_path_factory.mktemp("ckpt"), 0, variables["params"],
                               variables["batch_stats"])


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def _files(root):
    """Every file under `root`, relative, with the two packages' checkpoint
    formats named alike."""
    names = {"params.msgpack": "model", "batch_stats.msgpack": "model", "model.pt": "model"}
    return sorted({str(p.parent.relative_to(root) / names.get(p.name, p.name))
                   for p in root.rglob("*") if p.is_file()})


def test_cli_adapt_matches(tmp_path, weights, capsys):
    """`cli.adapt` of both packages on one YAML that loads the JAX-written
    checkpoint, 3 frames (`pipeline_depth: 1`, loop closure on, periodic
    plots every 2 frames): the same trajectory report within 1e-3 m and the
    same output files (metrics, log, plots, trajectory dumps, the pose
    graph's OBJ, replay buffer, checkpoint)."""
    reports = {}
    for name, main, extra in (("jax", jax_adapt.main, []),
                              ("port", adapt.main, ["--device", "cpu"])):
        log = tmp_path / name
        path = tmp_path / f"{name}.yaml"
        path.write_text(YAML.format(log=log, weights=weights))
        assert main(["--config", str(path), "--max-steps", "3", "--no-progress"] + extra) == 0
        out = capsys.readouterr().out
        assert f"slam: loaded weights from {weights}" in out
        assert "plotting skipped" not in out
        reports[name] = [l for l in out.splitlines() if "(m)" in l or "(%)" in l or "(deg" in l]
        assert "throughput:" in out
    assert len(reports["port"]) == len(reports["jax"]) >= 3
    for got, want in zip(reports["port"], reports["jax"]):
        assert got.split(":")[0] == want.split(":")[0]
        np.testing.assert_allclose(_numbers(got), _numbers(want), atol=1e-3)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert "pose_graph_2.obj" in _files(tmp_path / "port")


def test_chained_dataset_matches():
    """`ChainedDataset` of two synthetic worlds: the same samples (images,
    calibration, chained poses) as the JAX package's, and `sample_to_batch`
    gives a one-sample batch on the CPU."""
    def make(cls, chained):
        return chained([cls(num_frames=4, height=32, width=64, trajectory="loop", seed=s)
                        for s in (7, 11)])

    port, ref = make(SyntheticDataset, ChainedDataset), make(JaxSyntheticDataset,
                                                             JaxChainedDataset)
    assert len(port) == len(ref) == 8
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a.index == b.index == i and port.domain_of(i) == ref.domain_of(i)
        for field in ("rgb", "K", "rel_dist", "rel_pose", "abs_pose"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    np.testing.assert_array_equal(np.asarray(port.global_poses), np.asarray(ref.global_poses))
    batch = sample_to_batch(port[5], device="cpu")
    assert batch.batch_size == 1 and tuple(batch.rgb.shape) == (1, 3, 32, 64, 3)


def test_visualize_in_meshlab_matches(tmp_path):
    """The same pose graph in both packages writes the same OBJ bytes."""
    rng = np.random.default_rng(0)
    poses = [np.eye(4)]
    for _ in range(6):
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        poses.append(poses[-1] @ T)
    out = {}
    for name, cls in (("jax", JaxPoseGraph), ("port", PoseGraph)):
        g = cls()
        for i, pose in enumerate(poses):
            g.add_vertex(i, pose, fixed=i == 0)
            if i:
                g.add_edge((i - 1, i), np.linalg.inv(poses[i - 1]) @ pose)
        g.add_edge((6, 1), np.linalg.inv(poses[6]) @ poses[1], is_loop_closure=True)
        g.visualize_in_meshlab(tmp_path / f"{name}.obj", verbose=False)
        out[name] = (tmp_path / f"{name}.obj").read_bytes()
    assert out["port"] == out["jax"] and out["port"].count(b"\nl ") == 7
