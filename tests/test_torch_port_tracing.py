"""The port's tracer (`tpuslam_torch/tracing.py`) and the spans and counters
on its hot path, on the CPU at tiny sizes: the span tree of an adapting
`Slam` frame, the tracer off (nothing recorded, no profiler call) and on
(the same losses and poses), the bytes `make_frame_batch` ships, the
`Prefetcher`'s two threads, `profiling.trace`, the encoders' spans and
images at ResNet-50, and the reduction of a profiler's trace by span on
hand-made tuples."""
import copy
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuslam_torch import tracing
from tpuslam_torch.config import Config
from tpuslam_torch.config.schema import DatasetConfig, DepthPoseConfig, SlamConfig
from tpuslam_torch.data.base import Prefetcher, Sample, random_color_jitter
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.slam import Slam
from tpuslam_torch.train.batch import make_frame_batch
from tpuslam_torch.train.pretrain import host_batches
from tpuslam_torch.train.state import make_pretrain_optimizer, make_train_state
from tpuslam_torch.train.steps import LossConfig, adapt_step, train_step
from tpuslam_torch.utils.profiling import reduce_by_span, trace

torch.set_num_threads(1)

K_ITERS = 2
FRAMES = 4
PHASES = ["step.decode", "step.warp_loss", "step.backward", "step.adam"]


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _slam(tmp_path, depth: int) -> Slam:
    cfg = Config()
    cfg.dataset = DatasetConfig(dataset="Synthetic", height=32, width=96, num_frames=FRAMES + 2)
    cfg.depth_pose = DepthPoseConfig(log_path=str(tmp_path), batch_size=3, dtype="float32")
    cfg.slam = SlamConfig(adaptation=True, adaptation_epochs=K_ITERS, pipeline_depth=depth,
                          plot_frequency=0)
    return Slam(cfg, device="cpu")


def _run(slam: Slam) -> dict:
    for _ in range(FRAMES):
        slam.step()
    slam.flush_pipeline()
    return {"depth": list(slam.depth_loss), "velocity": list(slam.velocity_loss),
            "poses": np.stack(slam.pose_graph.get_all_poses())}


def _children(records, i):
    return [r for r in records if r.parent == i]


@pytest.mark.parametrize("depth", [0, 1])
def test_adapting_slam_records_the_span_tree(tmp_path, depth):
    """One `slam.step` per frame; each `step.adapt` holds K `step.iter`,
    each with the four phases in order; the `slam.retire` of frame t
    carries t, inside the `slam.step` of frame t + depth (or the closing
    flush); every span lies inside its parent and serves its parent's
    frame unless it names its own."""
    slam = _slam(tmp_path, depth)
    tracing.enable()
    _run(slam)
    records = tracing.records()
    assert {r.thread for r in records} == {threading.get_ident()}

    steps = [r for r in records if r.name == "slam.step"]
    assert [r.uid for r in steps] == list(range(1, FRAMES + 1))
    adapts = [i for i, r in enumerate(records) if r.name == "step.adapt"]
    assert len(adapts) == FRAMES
    for i in adapts:
        iters = [j for j, r in enumerate(records) if r.parent == i and r.name == "step.iter"]
        assert len(iters) == K_ITERS
        for j in iters:
            assert [r.name for r in _children(records, j)] == PHASES
            assert records[j].uid == records[i].uid

    retires = {r.uid: r for r in records if r.name == "slam.retire"}
    assert sorted(retires) == list(range(1, FRAMES + 1))
    for t, r in retires.items():
        around = records[r.parent]
        if t + depth <= FRAMES:
            assert (around.name, around.uid) == ("slam.step", t + depth)
        else:
            assert around.name == "slam.flush"
    for r in records:
        if r.parent is not None:
            p = records[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns, (r, p)
            if r.name != "slam.retire":
                assert r.uid == p.uid, (r, p)

    snap = tracing.snapshot()
    spans = snap["spans"]
    assert spans["step.iter"]["count"] == FRAMES * K_ITERS
    assert spans["data.jitter"]["count"] == 3 * 2 * spans["data.replay.draw"]["count"]
    for name, s in spans.items():
        assert 0 <= s["self_s"] <= s["total_s"], name
    # every frame reads back its packed vector, f32, and its depth (logging)
    packed = 16 + 512 + 3 + 512
    assert snap["counters"]["d2h_bytes"] == FRAMES * 4 * (packed + 32 * 96)


def test_tracer_off_records_nothing_and_on_changes_nothing(tmp_path, monkeypatch):
    """Off: no span, no counter, and no profiler range is entered.  On: the
    same losses and poses, bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the tracer off")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        off = _run(_slam(tmp_path / "off", 1))
    assert tracing.records() == [] and tracing.snapshot() == {"spans": {}, "counters": {}}
    tracing.enable()
    on = _run(_slam(tmp_path / "on", 1))
    assert tracing.snapshot()["spans"]["slam.step"]["count"] == FRAMES
    assert on["depth"] == off["depth"] and on["velocity"] == off["velocity"]
    np.testing.assert_array_equal(on["poses"], off["poses"])


@pytest.mark.parametrize("with_aug", [False, True])
def test_h2d_bytes_are_the_bytes_shipped(with_aug):
    """`h2d_bytes` after one `make_frame_batch` is the bytes of the tensors
    it made from host arrays (the augmented images only where given: without
    them the batch reuses the shipped `rgb`); the float images go through
    the rounding span `data.to_uint8`."""
    rng = np.random.default_rng(0)
    B, H, W = 2, 8, 16
    rgb = rng.uniform(size=(B, 3, H, W, 3)).astype(np.float32)
    aug = rng.uniform(size=(B, 3, H, W, 3)).astype(np.float32) if with_aug else None
    tracing.enable()
    batch = make_frame_batch(rgb, np.eye(4), np.ones((B, 2)), rgb_aug=aug, device="cpu",
                             mask=np.zeros((B, H, W)))
    shipped = [batch.rgb, batch.K, batch.inv_K, batch.rel_dist, batch.weights, batch.mask]
    if with_aug:
        shipped.append(batch.rgb_aug)
    else:
        assert batch.rgb_aug is batch.rgb
    snap = tracing.snapshot()
    assert snap["counters"] == {"h2d_bytes": sum(t.numel() * t.element_size() for t in shipped)}
    assert snap["spans"]["data.to_uint8"]["count"] == 1 + with_aug
    assert snap["spans"]["data.frame_batch"]["count"] == 1


def test_prefetcher_spans_share_batch_ids_across_threads():
    """`train.batch` k (its samples, jitter and stack) runs on the
    `Prefetcher`'s thread, `train.wait` k on the caller's; the last wait
    is the end of the epoch."""
    rng = np.random.default_rng(1)

    class Jittered:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            rgb = rng.uniform(size=(3, 4, 8, 3)).astype(np.float32)
            jitter = random_color_jitter(rng)
            return Sample(index=i, rgb=rgb, K=np.eye(4, dtype=np.float32),
                          rel_dist=np.ones(2, np.float32),
                          rgb_aug=np.stack([jitter(f) for f in rgb]))

    tracing.enable()
    batches = list(Prefetcher(host_batches(Jittered(), 2, np.random.default_rng(0))))
    assert len(batches) == 3
    records = tracing.records()
    me = threading.get_ident()
    built = [r for r in records if r.name == "train.batch"]
    waits = [r for r in records if r.name == "train.wait"]
    assert [r.uid for r in built] == [0, 1, 2] and {r.thread for r in built} != {me}
    assert [r.uid for r in waits] == [0, 1, 2, 3] and {r.thread for r in waits} == {me}
    for i, r in enumerate(records):
        if r.name == "train.batch":
            kids = _children(records, i)
            assert [k.name for k in kids] == ["data.sample"] * 2 + ["train.stack"]
            assert all(k.uid == r.uid for k in kids)
    spans = tracing.snapshot()["spans"]
    assert spans["data.jitter"]["count"] == 6 * 3


def _steps_at_resnet50():
    """A ResNet-50 model, a batch of 2 triplets at 32 x 64 and a loss
    config of the plain sampler, float32."""
    ds = SyntheticDataset(num_frames=3, height=32, width=64, do_augmentation=True)
    samples = [ds[i] for i in range(2)]
    batch = make_frame_batch(np.stack([s.rgb for s in samples]), ds.K,
                             np.stack([s.rel_dist for s in samples]),
                             rgb_aug=np.stack([s.aug for s in samples]), device="cpu")
    cfg = LossConfig(scales=(0, 1), use_pallas_warp=False, pallas_bf16_out=False,
                     bf16_networks=False)
    return init_depth_pose(0, resnet_depth=50, resnet_pose=50, scales=(0, 1), device="cpu"), \
        batch, cfg


def _train(model, batch, cfg, steps: int = 2):
    state = make_train_state(model, make_pretrain_optimizer(model, 1e-4), seed=3)
    return [train_step(state, cfg, batch)["loss"] for _ in range(steps)]


def _encoder_children(records, around: str):
    return [[r.name for r in _children(records, i)]
            for i, r in enumerate(records) if r.name == around]


def test_encoder_spans_at_resnet50():
    """At ResNet-50: `train_step`'s `step.encode` holds `step.encode.depth`
    then `step.encode.pose`, and `adapt_step`'s `step.frozen` holds the
    same two; neither step counts anything.  Off, nothing is recorded and
    the losses are those of the tracer on, bit for bit."""
    model, batch, cfg = _steps_at_resnet50()
    start = copy.deepcopy(model)
    off = _train(model, batch, cfg)
    assert tracing.snapshot() == {"spans": {}, "counters": {}}

    tracing.enable()
    model = copy.deepcopy(start)
    on = _train(model, batch, cfg)
    records = tracing.records()
    assert _encoder_children(records, "step.encode") == [
        ["step.encode.depth", "step.encode.pose"]] * 2
    assert tracing.snapshot()["counters"] == {}
    assert [float(x) for x in on] == [float(x) for x in off]

    tracing.reset()
    model.requires_grad_(False)
    model.depth_decoder.requires_grad_(True)
    model.pose_decoder.requires_grad_(True)
    state = make_train_state(model, torch.optim.Adam(
        [p for p in model.parameters() if p.requires_grad], lr=1e-4), seed=3)
    adapt_step(state, cfg, batch, 2)
    records = tracing.records()
    frozen = [i for i, r in enumerate(records) if r.name == "step.frozen"]
    assert len(frozen) == 1
    assert [r.name for r in _children(records, frozen[0])] == [
        "step.encode.depth", "step.encode.pose"]
    assert tracing.snapshot()["counters"] == {}


def test_readme_names_the_encoder_spans():
    """The README's list of spans names the encoders' own."""
    readme = (Path(__file__).resolve().parents[1] / "README.md").read_text()
    for name in ("step.encode.depth", "step.encode.pose"):
        assert name in readme, name


def test_trace_turns_the_tracer_on_for_its_block(tmp_path):
    """`profiling.trace` turns the tracer on for its block only, and its
    Chrome trace holds the program's spans under the prefix, a second
    thread's too."""
    def worker():
        with tracing.span("train.batch", 0):
            pass

    with trace(tmp_path) as prof:
        assert tracing.on
        with tracing.span("slam.step", 7):
            torch.ones(8, 8) @ torch.ones(8, 8)
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert prof is not None and not tracing.on
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {tracing.PREFIX + "slam.step", tracing.PREFIX + "train.batch"} <= names
    assert tracing.snapshot()["spans"]["slam.step"]["count"] == 1
    tracing.enable()
    with trace(tmp_path):
        pass
    assert tracing.on


def test_reduce_by_span_labels_gaps_and_attributes_launches():
    """Hand-made trace (microseconds): main thread 1 runs ts:step.iter
    (0-100) with ts:step.backward (40-90) inside, under a harness range
    pb:steps.adapt_step (0-120); autograd's thread 2 launches kernel 3
    while step.backward is open on thread 1; thread 3 (a data thread)
    launches nothing, so its open span names neither a gap nor a launch."""
    ranges = [(0.0, 120.0, "pb:steps.adapt_step", 1), (0.0, 100.0, "ts:step.iter", 1),
              (40.0, 90.0, "ts:step.backward", 1), (0.0, 200.0, "ts:data.sample", 3)]
    device = [(10.0, 20.0, "k1", 1), (31.0, 35.0, "k2", 2), (60.0, 70.0, "k3", 3),
              (150.0, 151.0, "k4", 4), (200.0, 204.0, "k5", 5)]
    launches = {1: (5.0, 1), 2: (25.0, 1), 3: (50.0, 2), 4: (105.0, 1), 5: (160.0, 1)}
    got = reduce_by_span(device, launches, ranges)
    assert got["launches_by_span"] == {"step.iter": 2, "step.backward": 1,
                                       "outside the spans": 2}
    assert got["device_by_span"] == pytest.approx(
        {"step.iter": 14e-6, "step.backward": 10e-6, "outside the spans": 5e-6})
    # gaps, by the range open at their middle: 20-31 (25.5), 35-60 (47.5),
    # 70-150 (110: only the harness's range is open), 151-200 (175.5)
    assert got["idle_by_span"] == pytest.approx(
        {"step.iter": 11e-6, "step.backward": 25e-6, "steps.adapt_step": 80e-6,
         "outside the spans": 49e-6})
    assert reduce_by_span([], {}, ranges)["idle_by_span"] == {}
