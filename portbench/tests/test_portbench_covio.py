"""CoVIO's asynchronous mode in the harness, on the CPU at a tiny size, where
`Slam` runs each update synchronously and adopts it at the next frame: the
mode's own numbers against values worked out by hand, the launch rule on a
scripted sequence, and the FLOPs `mfu.covio` counts."""
from __future__ import annotations

import importlib.util

import pytest
import torch

from tiny import run_cell, shrink

CELL = "adapt-kitti-covio-async"


def test_sound_readings(monkeypatch):
    """On the CPU every frame of the window launches an update and the next
    frame adopts it; the window starts with none in flight and `finish_async`
    adopts the last, so n frames adopt n updates.  Every kept frame is
    served from the last update's output, every update runs K iterations."""
    shrink(monkeypatch)
    line, res = run_cell(CELL)
    run, numbers = res["run"], res["numbers"]
    assert run["units"] > 0
    assert run["updates"] == run["units"]
    assert res["e2e"]["updates_per_s"] == pytest.approx(run["units"] / run["window_s"])
    assert run["update_lag_frames"] == 1.0
    assert numbers["served_state_gap"] == 0.0
    assert numbers["update_iters"] == 0.0
    assert numbers["launch_rule"] == 0.0
    assert line["correct"], line["checks"]


def test_stale_served_fails(monkeypatch):
    """Each frame served from the state before the last one adopted: a kept
    frame's decoders differ from the last update's output by that update's
    K Adam steps, each of which moves an element by about lr, by at most
    (1 - b1) / sqrt(1 - b2) lr = 3.2 lr."""
    from test_portbench_correct import plant

    from portbench.lib import spec

    shrink(monkeypatch)
    plant(monkeypatch, CELL, "stale_served")
    line, res = run_cell(CELL)
    run = spec.config(spec.cell(CELL)["config"])["run"]
    lr = run["DepthPosePrediction"]["learning_rate"]
    K = run["Slam"]["adaptation_epochs"]
    gap = res["numbers"]["served_state_gap"]
    assert 0.5 * lr < gap <= 3.2 * K * lr
    assert not line["correct"]


def test_short_update_fails(monkeypatch):
    """Updates of K - 1 iterations read 1 on `update_iters`."""
    from test_portbench_correct import plant

    shrink(monkeypatch)
    plant(monkeypatch, CELL, "short_update")
    line, res = run_cell(CELL)
    assert res["numbers"]["update_iters"] == 1.0
    assert not line["correct"]


def test_launch_rule_by_hand():
    """Frames 0-5: 0 launches u0; 1 adopts it and launches u1; 2 finds u1 in
    flight and launches none; 3 finds none in flight after adopting u1 and
    launches none (one violation); 4 launches u2 while none is in flight,
    and again (one violation); 5 launches u3 with u2 in flight (one
    violation)."""
    from portbench.lib.covio_cell import launch_violations

    events = [("serve", 0, None), ("launch", 0, 0),
              ("adopt", 1, 0), ("serve", 1, None), ("launch", 1, 1),
              ("serve", 2, None),
              ("adopt", 3, 1), ("serve", 3, None),
              ("serve", 4, None), ("launch", 4, 2), ("launch", 4, 3),
              ("serve", 5, None), ("launch", 5, 4)]
    assert launch_violations(events, range(0, 3)) == 0
    assert launch_violations(events, range(0, 6)) == 3
    assert launch_violations(events, range(6, 7)) == 1  # a frame never served


def _reader(metric: str):
    from portbench.lib import spec

    path = spec.BENCH / "metrics" / f"{metric}.py"
    module_spec = importlib.util.spec_from_file_location("m_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def test_mfu_covio_flops(monkeypatch):
    """At the tiny size: served frames times one served frame's FLOPs (the
    encoders at batch 1, the loop-closure embedding, the decoders' forward)
    plus adopted updates times one update's (the encoders at batch 3, K
    forward and backward passes of the decoders), counted here over the
    reference networks directly."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.lib import slam_cell, spec
    from portbench.lib.peaks import FLOPS
    from portbench.reference.nets import DepthPoseNet

    shrink(monkeypatch)
    c = spec.cell(CELL)
    config = spec.config(c["config"])
    settings = slam_cell.settings(config, c)
    ds, pc = settings["Dataset"], settings["DepthPosePrediction"]
    K, B, H, W = settings["Slam"]["adaptation_epochs"], pc["batch_size"], ds["height"], ds["width"]

    def count(batch: int, passes: int, train: bool, embed: bool) -> int:
        with torch.device("meta"):
            net = DepthPoseNet(tuple(pc["scales"]), 18)
            images, pairs = torch.zeros(batch, H, W, 3), torch.zeros(2 * batch, H, W, 6)
        with FlopCounterMode(display=False) as counter:
            with torch.no_grad():
                feats = net.depth_encoder(images)
                pose = net.pose_encoder(pairs)[-1]
                if embed:
                    net.depth_encoder(images[:1])
            for _ in range(passes):
                disps = net.depth_decoder([f.detach() for f in feats])
                aa, tr = net.pose_decoder(pose.detach())
                if train:
                    (sum(d.sum() for d in disps.values()) + aa.sum() + tr.sum()).backward()
        return counter.get_total_flops()

    served, update = count(1, 1, False, True), count(B, K, True, False)
    module = _reader("mfu.covio")
    assert module.loop_flops(settings, 7, 3) == 7 * served + 3 * update
    run = {"kind": "slam", "units": 7, "updates": 3, "window_s": 2.0, "spans": {"total": {}},
           "settings": settings, "spec": config}
    want = 100.0 * (7 * served + 3 * update) / 2.0 / FLOPS[config["precision"]]
    assert module.read(run) == pytest.approx(want, rel=1e-12)


def test_side_stream_readers_by_hand():
    """A slice whose side stream (the first spin kernel, 0.1 s) is busy over
    [1, 3] and [4, 6] and whose serving stream over [2, 5]: 4.1 s busy, 2 s
    of it overlapped, over 2 updates."""
    from portbench.lib.covio_cell import side_streams

    sl = {"streams": {13: [(0.0, 0.1, "spin_kernel"), (1.0, 3.0, "a"), (4.0, 6.0, "b")],
                      7: [(0.5, 0.6, "spin_kernel"), (2.0, 5.0, "c")]}}
    side = side_streams(sl, 2)
    assert side == {"updates": 2, "busy_s": pytest.approx(4.1),
                    "serving_busy_s": pytest.approx(3.1), "overlap_s": pytest.approx(2.0)}
    run = {"kind": "slam", "slice": {"side": side}}
    assert _reader("update_device_ms.covio").read(run) == pytest.approx(2050.0)
    assert _reader("overlap_share.covio").read(run) == pytest.approx(100.0 * 2.0 / 4.1)
