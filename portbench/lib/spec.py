"""Everything a run reads, found by name: the cell in `BENCHMARK.json` and
`workloads/<cell>.json`, its configuration `configs/<config>.json`, its
traffic `traffic/<traffic>.json` and the readers `metrics/<metric>.py` of
its per-layer metrics."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from portbench.lib.env import ROOT

BENCH = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's `workloads` entry merged with its own file."""
    entries = [w for w in manifest()["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    out = dict(entries[0])
    out.update(load_json(BENCH / "workloads" / f"{name}.json"))
    return out


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def end_to_end(c: dict) -> list:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest()["end_to_end"]
            if "workloads" not in m or c["name"] in m["workloads"]]


def per_layer(c: dict) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(c)}
    return [m for m in manifest()["per_layer"]
            if (c["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(metric: str):
    """`read(run)` of `metrics/<metric>.py`."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
