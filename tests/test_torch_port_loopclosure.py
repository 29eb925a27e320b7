"""Loop closure and the pipelined loop of the PyTorch port against the JAX
package.

The retrieval (`LoopClosureDetection`, `batched_cosine_topk`) and the two
`Slam`s side by side on the synthetic world's closed loop at 64 x 192 (float32 networks, float32
warp storage, the port's networks carrying the JAX Slam's initial weights).
A loop edge fires on `sim > detection_threshold`; every search's
similarities are logged and held at least 1e-3 away from the threshold, so
that "the same loop edges" is not decided by rounding.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuslam.posegraph.native as jax_native
from tpuslam.config import parse_config as jax_parse_config
from tpuslam.loopclosure import LoopClosureDetection as JaxLoopClosureDetection
from tpuslam.memory.index import batched_cosine_topk as jax_topk
from tpuslam.slam import Slam as JaxSlam
from tpuslam_torch.checkpoint.from_jax import load_jax_variables
from tpuslam_torch.config import parse_config
from tpuslam_torch.config.schema import DatasetConfig
from tpuslam_torch.loopclosure import LoopClosureDetection
from tpuslam_torch.memory.index import batched_cosine_topk
from tpuslam_torch.slam import Slam
from tpuslam_torch.train.steps import eval_step

torch.set_num_threads(1)

THRESHOLD = 0.5  # random weights give similarities of 0.98-1.0

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
ReplayBuffer:
  max_buffer_size: 8
  similarity_threshold: 0.999
LoopClosureDetection:
  detection_threshold: {threshold}
  id_threshold: 3
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
    """The JAX Slam's solves build the JAX package's C++ solver into
    `native/` at first use; here it is built into a temporary directory, so
    that this file writes nothing there and races no other test process
    that builds it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", tmp_path_factory.mktemp("native") / "libposegraph.so")
        mp.setattr(jax_native, "_lib", None)
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _log_searches(det):
    """Record, for every search of a loop-closure detector, the
    similarities of the candidates that the id filter lets through."""
    log, search = [], det.search

    def logged(frame_id):
        sims, ids = det.index.search(det.index.reconstruct(frame_id)[None],
                                     min(100, det.index.ntotal))
        ok = (ids[0] >= 0) & (np.abs(ids[0] - frame_id) > det.id_threshold)
        log.append((frame_id, sims[0][ok]))
        return search(frame_id)

    det.search = logged
    return log


def _clear_of_threshold(log, threshold):
    sims = np.concatenate([s for _, s in log])
    print("loop-closure searches:", [(f, np.round(s, 5).tolist()) for f, s in log])
    assert len(sims) and np.abs(sims - threshold).min() > 1e-3, sims


def _slams(tmp_path, adaptation, depth, frames=12):
    path = tmp_path / "slam.yaml"
    path.write_text(YAML.format(frames=frames, log=tmp_path / "log", threshold=THRESHOLD,
                                adaptation=str(adaptation).lower(), depth=depth))
    jslam = JaxSlam(jax_parse_config(path))
    slam = Slam(parse_config(path), device="cpu")
    load_jax_variables(slam.model, jslam.state.params, jslam.state.batch_stats)
    return jslam, slam


def _edges(slam):
    return [(d["step"], d["lc_id"]) for d in slam.lc_edge_diagnostics]


def test_search_matches_jax(rng):
    """The same embeddings in both detectors: the same candidate ids and
    similarities (1e-6) for every keyframe, at a threshold none of them is
    within 1e-3 of."""
    emb = rng.normal(size=(40, 512)).astype(np.float32)
    emb[20:] = emb[:20] + 0.3 * rng.normal(size=(20, 512)).astype(np.float32)
    dets = [cls(detection_threshold=0.8, id_threshold=5, num_matches=2, num_features=512)
            for cls in (JaxLoopClosureDetection, LoopClosureDetection)]
    for det in dets:
        for i, e in enumerate(emb):
            det.add(i + 1, e)
    log = _log_searches(dets[1])
    found = 0
    for frame_id in range(1, 41):
        (jids, jsims), (ids, sims) = (d.search(frame_id) for d in dets)
        assert ids == jids, frame_id
        np.testing.assert_allclose(sims, jsims, atol=1e-6)
        found += len(ids)
    assert found > 10
    _clear_of_threshold(log, 0.8)
    assert LoopClosureDetection.predict(emb[0], emb[20]) == pytest.approx(
        JaxLoopClosureDetection.predict(emb[0], emb[20]), abs=1e-6)
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        dets[1].display_matches(1, None, [], [])


def test_batched_cosine_topk_matches_jax(rng):
    """Top-k of 16 queries over 300 vectors: the same indices, similarities
    within 1e-6."""
    q = rng.normal(size=(16, 64)).astype(np.float32)
    v = rng.normal(size=(300, 64)).astype(np.float32)
    sims, idx = batched_cosine_topk(torch.from_numpy(q), torch.from_numpy(v), k=10)
    jsims, jidx = jax_topk(jnp.asarray(q), jnp.asarray(v), k=10)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=1e-5)


def _log_packed(slam):
    """Record the packed readback of every frame `slam` dispatches."""
    log, dispatch = [], slam._dispatch

    def logged(sample):
        entry = dispatch(sample)
        log.append(np.array(entry["outputs"][("retire_packed",)], np.float64))
        return entry

    slam._dispatch = logged
    return log


def test_slam_inference_loop_closures_match_jax(tmp_path):
    """`adaptation: false` on a 12-frame loop.  Each frame's packed readback
    of `eval_step(with_lc_embedding=True)` (pose, embedding, losses, then
    the loop-closure embedding) within 1e-4 relative, the loop-closure
    embedding alone within 1e-5; the same searches, the same loop edges (at
    least one), the same solve backend, and poses after the solves within
    1e-4.  Without the loop-closure embedding the packed vector ends at the
    losses."""
    jslam, slam = _slams(tmp_path, adaptation=False, depth=0)
    jlog, log = (_log_searches(s.loop_closure_detection) for s in (jslam, slam))
    jpacked, packed = _log_packed(jslam), _log_packed(slam)
    jslam.run(max_steps=12, progress=False)
    slam.run(max_steps=12, progress=False)
    assert len(packed) == len(jpacked) == 12
    for got, want in zip(packed, jpacked):
        assert got.shape == want.shape == (16 + 512 + 3 + 512,)
        assert _rel(got, want) < 1e-4 and _rel(got[-512:], want[-512:]) < 1e-5
    _clear_of_threshold(jlog + log, THRESHOLD)
    assert [f for f, _ in log] == [f for f, _ in jlog]
    assert _edges(slam) == _edges(jslam) and slam.pose_graph.num_loop_closures >= 1
    assert slam.pose_graph.num_loop_closures == jslam.pose_graph.num_loop_closures
    assert slam.pose_graph.last_backend == "native"
    np.testing.assert_allclose([d["sim"] for d in slam.lc_edge_diagnostics],
                               [d["sim"] for d in jslam.lc_edge_diagnostics], atol=1e-5)
    np.testing.assert_allclose(np.stack(slam.pose_graph.get_all_poses()),
                               np.stack(jslam.pose_graph.get_all_poses()), atol=1e-4)
    batch = slam._sample_to_batch(slam.dataset[0])
    _, plain = eval_step(slam.model, slam.loss_cfg, batch)
    assert ("lc_embedding",) not in plain and plain[("retire_packed",)].shape == (531,)


def test_slam_adaptation_pipelined_matches_jax(tmp_path):
    """Adaptation (K = 2, batch 3 with replay) with `pipeline_depth: 2` on a
    12-frame loop: the same replay composition, the same loop edges (at
    least one), and the trajectory within 1e-3, as `test_torch_port_slam.py`
    holds the unpipelined loop (the tie-break noise of the JAX step comes
    from jax.random)."""
    jslam, slam = _slams(tmp_path, adaptation=True, depth=2)
    jlog, log = (_log_searches(s.loop_closure_detection) for s in (jslam, slam))
    jslam.run(max_steps=12, progress=False)
    slam.run(max_steps=12, progress=False)
    assert not slam._retire_queue and slam.pose_graph.vertex_ids == list(range(13))
    _clear_of_threshold(jlog + log, THRESHOLD)
    assert slam.replay_composition == jslam.replay_composition
    assert _edges(slam) == _edges(jslam) and slam.pose_graph.num_loop_closures >= 1
    np.testing.assert_allclose(slam.trajectory(), jslam.trajectory(), atol=1e-3)
    np.testing.assert_allclose(slam.depth_loss, jslam.depth_loss, rtol=1e-3)


def test_pipeline_depth_inference_exact(tmp_path):
    """With frozen weights the pipelined loop (`pipeline_depth: 3`) equals
    the per-frame one: the deferral moves only when the host bookkeeping
    runs.  Trajectory, loop edges and metrics within 1e-6."""
    runs = []
    for depth in (0, 3):
        path = tmp_path / f"d{depth}.yaml"
        path.write_text(YAML.format(frames=12, log=tmp_path / f"log{depth}",
                                    threshold=THRESHOLD, adaptation="false", depth=depth))
        slam = Slam(parse_config(path), device="cpu")
        steps = [slam.step() for _ in range(12)]
        if depth:
            assert len(slam._retire_queue) == depth and len(slam.pose_graph) == 13 - depth
            assert steps[0] == {"depth_loss": 0.0, "velocity_loss": 0.0}
        runs.append((slam, slam.trajectory()))
    (ref, ref_traj), (pipe, pipe_traj) = runs
    assert not pipe._retire_queue
    assert pipe.pose_graph.vertex_ids == ref.pose_graph.vertex_ids
    assert _edges(pipe) == _edges(ref) and pipe.pose_graph.num_loop_closures >= 1
    np.testing.assert_allclose(pipe_traj, ref_traj, atol=1e-6)
    np.testing.assert_allclose(pipe.rel_trans_error, ref.rel_trans_error, atol=1e-6)
    np.testing.assert_allclose(pipe.depth_loss, ref.depth_loss, atol=1e-6)


def test_adapt_kitti_settings_run_on_cpu(tmp_path):
    """The `Slam` and `LoopClosureDetection` settings of the shipped
    `adapt_kitti.yaml` (adaptation K = 5, `pipeline_depth: 3`,
    `do_loop_closures: true`, `embedder: depth_encoder`,
    `keyframe_frequency: 5`, `lc_distance_poses: 150`) drive `Slam.run` on
    the synthetic loop at 64 x 192 on the CPU.  Changed from the file: the
    dataset, the log and buffer paths, no weights folder, no periodic plots,
    `id_threshold` 2 and `detection_threshold` 0.5 (random weights, 6
    frames).  The prefetch hands the frames over in order, the pipeline is
    drained, one loop edge fires and the native solver closes it; the
    candidate-image LRU serves repeats without the dataset and stays
    bounded."""
    from pathlib import Path

    cfg = parse_config(Path(__file__).resolve().parents[1]
                       / "tpuslam/config/defaults/adapt_kitti.yaml")
    assert (cfg.slam.pipeline_depth, cfg.slam.do_loop_closures, cfg.slam.keyframe_frequency,
            cfg.slam.lc_distance_poses, cfg.loop_closure.embedder) == (
        3, True, 5, 150, "depth_encoder")
    cfg.dataset = DatasetConfig(dataset="Synthetic", height=64, width=192, num_frames=6,
                                trajectory="loop")
    cfg.depth_pose.load_weights_folder = None
    cfg.depth_pose.log_path = tmp_path / "log"
    cfg.replay_buffer.load_path = None
    cfg.slam.plot_frequency = 0
    cfg.loop_closure.id_threshold = 2
    cfg.loop_closure.detection_threshold = 0.5
    slam = Slam(cfg, device="cpu")
    seen, step = [], slam.step
    slam.step = lambda sample: seen.append(sample.index) or step(sample)
    slam.run(max_steps=6, progress=False, prefetch_depth=3)
    assert seen == list(range(6)) and slam.current_step == 6
    assert not slam._retire_queue and slam.pose_graph.vertex_ids == list(range(7))
    assert slam.pose_graph.num_loop_closures == 1 and slam.pose_graph.last_backend == "native"
    assert slam.since_last_loop_closures < 150
    assert np.isfinite(slam.depth_loss).all() and len(slam.rel_trans_error) == 6
    assert "Abs traj RMSE" in slam.final_report()
    assert slam.save_metrics().exists() and slam.trajectory().shape == (7, 3)

    img = slam._lc_image(2)
    dataset = slam.dataset

    class Unread:
        def __len__(self):
            return len(dataset)

        def __getitem__(self, index):
            raise AssertionError(f"frame {index} read again")

    slam.dataset = Unread()
    np.testing.assert_array_equal(slam._lc_image(2), img)  # served from the LRU
    slam.dataset = dataset
    slam._lc_cache_size = 2
    for lc_id in (3, 4, 5):
        slam._lc_image(lc_id)
    assert list(slam._lc_cache) == [3, 4]
    assert slam._lc_image(99) is None
