"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `portbench/` and the
program (`tpuslam_torch`), on a machine with the CUDA cards the cell asks for.
The last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1` a `breakdown`,
and last `checks`, each number compared with its limit.  Standard error ends
with the same checks.  Without the cards, the program, or with JAX loaded,
it exits with another code than 0 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    args.seed = args.seed % (2 ** 63)
    return args


def result_line(res: dict, cell: dict, trace: bool) -> dict:
    from portbench.lib import compare, env, spec

    manifest = spec.manifest()
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    metrics = {}
    if trace:
        for m in spec.per_layer(cell):
            value = spec.reader(m["name"])(res["run"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        for m in spec.end_to_end(cell):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": units[m["name"]]}
    card = env.card()
    device = {"platform": "gpu", "kind": card["kind"], "count": card["count"],
              "memory_peak_bytes": res["memory_peak_bytes"], "power_limit": card["power_limit"]}
    line = {"correct": False, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    sl = res["run"].get("slice")
    if trace and sl is not None:
        device["busy_s"], device["window_s"] = sl["busy_s"], sl["wall_s"]
        top = sorted(sl["by_name"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(sl["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                             "idle_gaps": [[n, s] for n, s in gaps]}
    numbers = dict(res["numbers"], failed_units=float(res["failed"]))
    ok, checks = compare.judge(numbers, dict(cell["limits"], failed_units=0.0))
    line["correct"] = ok
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from portbench.lib import compare, env, spec

    env.set_caches()
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if config["entry"] == "slam":
        from portbench.lib import slam_cell as driver
    else:
        from portbench.lib import pretrain_cell as driver
    res = driver.run(args, cell, config, traffic, {})
    line = result_line(res, cell, bool(args.trace))
    found = env.loaded_forbidden()
    if found:
        print(f"portbench: modules that may not load were loaded: {found}", file=sys.stderr)
        return 4
    compare.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
