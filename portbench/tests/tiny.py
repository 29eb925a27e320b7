"""A cell at a size the CPU holds: the harness's own specs, shrunk in place
(96x320 SLAM frames, 64x192 pretraining ones, few rendered frames, small
pools, the SLAM networks in float32, whose bf16 autocast on the CPU rounds
unlike the card's), with the harness driving the program's plain kernels
on the CPU."""
from __future__ import annotations

import copy
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import env, spec  # noqa: E402

CELLS = tuple(w["name"] for w in spec.manifest()["workloads"])


def shrink(monkeypatch, device: str = "cpu") -> None:
    """Run the harness at a tiny size, on the CPU unless `device` says "cuda"."""
    cell, config, traffic = spec.cell, spec.config, spec.traffic

    def tiny_cell(name):
        c = cell(name)
        if "check_window_frames" in c:
            c["check_window_frames"] = [[0, 1], [1, 2]]
        if "check_window_steps" in c:
            c["check_window_steps"] = [[0, 1], [1, 2]]
        c["trace_slice"] = 2
        if "warmup_frames" in c:
            c["warmup_frames"] = min(c["warmup_frames"], 6)
        return c

    def tiny_config(name):
        c = copy.deepcopy(config(name))
        if c["entry"] == "slam":
            c["run"]["Dataset"].update(height=96, width=320)
            c["run"]["DepthPosePrediction"]["dtype"] = "float32"
        else:
            c["run"]["Pretrainer"].update(height=64, width=192, batch_size=4)
        return c

    def tiny_traffic(name):
        t = copy.deepcopy(traffic(name))
        t["workers"] = 1
        if "rendered_frames" in t:
            t["rendered_frames"] = 40
        if "pool_frames" in t:
            t.update(pool_frames=10, steps_per_epoch=2)
        return t

    monkeypatch.setattr(env, "DEVICE", device)
    monkeypatch.setattr(spec, "cell", tiny_cell)
    monkeypatch.setattr(spec, "config", tiny_config)
    monkeypatch.setattr(spec, "traffic", tiny_traffic)


def run_cell(name: str, trace: int = 0, seconds: float = 2.0, seed: int = 2 ** 40 + 3):
    """One run of a shrunk cell through the harness: (result line, result)."""
    from portbench import run

    c = spec.cell(name)
    config = spec.config(c["config"])
    if config["entry"] == "slam":
        from portbench.lib import slam_cell as driver
    else:
        from portbench.lib import pretrain_cell as driver
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    res = driver.run(args, c, config, spec.traffic(c["traffic"]), {})
    return run.result_line(res, c, bool(trace)), res
