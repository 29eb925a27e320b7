"""The readings that the limits of `correct` are set from, for one cell.

    python3 portbench/controls.py --workload <name> --seeds 1,2,... \
        --control-seeds 3 --seconds <s> [--look] [--override JSON] \
        [--out chiprun_out/controls.json]

In one process, for each seed: a run of the cell with a short window (the
program's own readings, "sound"), then, on the same inputs, for the first
`--control-seeds` seeds:
- "control": the reference computed in the precision just below the one the
  configuration states (fp8 convolutions, forward and backward, for bf16
  networks, with the warp stored one type below the configuration's storage;
  TF32 for float32 networks with TF32 off), put in the program's place;
- the faults the cell can have, planted in the program's answers or in the
  reference put in its place: "half_batch" (half of each batch's rows left
  out, the loss their mean over the rest), "answer_altered" (each retired
  pose inverted, or each step's loss from the step before), "state_unchanged"
  (the training state handed back as it came); for CoVIO's asynchronous
  mode also "stale_served" (each kept frame served from the output of the
  update before the last one adopted).
`--look` adds, for every seed of a SLAM cell, the reference with bf16
convolutions against the float32 one on the same program state ("ref_bf16"),
and the leaves that read the widest change gaps on both sides, with each
leaf's size and its gradient against the median leaf's.  `--override` merges
JSON into the cell's `overrides`, such as the program's float32 networks:
'{"DepthPosePrediction": {"dtype": "float32"}}'.
Prints one line per reading and writes all of them as JSON to `--out`.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path


def slam_readings(kept: dict) -> dict:
    import numpy as np

    from portbench.lib import slam_cell as sc

    program, stream, cfg, seeds, want = (kept[k] for k in ("program", "stream", "cfg", "seeds",
                                                           "want"))
    import torch

    out = {}
    got = sc.reference_answers(program, stream, cfg, seeds, precision="control")
    out["control"] = sc.compare_answers(got, want)
    prog = sc.program_answers(program, stream)
    altered = dict(prog, pose={k: (np.linalg.inv(v) if v is not None else v)
                               for k, v in prog["pose"].items()})
    out["answer_altered"] = sc.compare_answers(altered, want)
    unchanged = dict(prog, moved={k: {n: 0.0 for n in v} for k, v in prog["moved"].items()})
    out["state_unchanged"] = sc.compare_answers(unchanged, want)
    halved = dict(program, kept={})
    for i, c in program["kept"].items():
        b = c["batch"]
        w = torch.zeros_like(b.weights)
        half = max(1, b.weights.shape[0] // 2)
        w[:half] = 1.0 / half
        halved["kept"][i] = dict(c, batch=dataclasses.replace(b, weights=w))
    out["half_batch"] = sc.compare_answers(
        sc.reference_answers(halved, stream, cfg, seeds), want)
    return out


def widest_leaves(side: dict, want: dict, program: dict, count: int = 3) -> list:
    """The `count` leaves with the widest change gaps between `side` and the
    reference, over the frames kept: [frame, leaf, gap, the reference's change,
    the side's change, elements, gradient / the median leaf's gradient]."""
    import numpy as np

    grads = want["grad"]
    median = float(np.median(list(grads.values())))
    rows = []
    for k, ref in want["moved"].items():
        keep = [n for n in ref if grads.get(n, 0.0) >= 1e-3 * median]
        floor = float(np.median([ref[n] for n in keep]))
        sizes = program["kept"][k]["before"]["params"]
        for n in keep:
            gap = abs(side["moved"][k][n] - ref[n]) / max(ref[n], floor, 1e-30)
            rows.append([k, n, gap, ref[n], side["moved"][k][n], sizes[n].numel(),
                         grads[n] / median])
    return sorted(rows, key=lambda r: -r[2])[:count]


def slam_look(kept: dict) -> dict:
    from portbench.lib import slam_cell as sc

    program, stream, cfg, seeds, want = (kept[k] for k in ("program", "stream", "cfg", "seeds",
                                                           "want"))
    prog = sc.program_answers(program, stream)
    bf16 = sc.reference_answers(program, stream, cfg, seeds, precision="bf16")
    return {"ref_bf16": sc.compare_answers(bf16, want),
            "leaves_program": widest_leaves(prog, want, program),
            "leaves_ref_bf16": widest_leaves(bf16, want, program)}


def covio_readings(kept: dict) -> dict:
    import numpy as np
    import torch

    from portbench.lib import covio_cell as cc
    from portbench.lib import env
    from portbench.lib.weights import encoder_depths, seeded_state_dict

    program, stream, cfg, seeds, want = (kept[k] for k in ("program", "stream", "cfg", "seeds",
                                                           "want"))
    out = {"control": cc.compare_answers(
        cc.reference_answers(program, stream, cfg, seeds, precision="control"), want)}
    prog = cc.program_answers(program, stream)
    altered = dict(prog, pose={k: (np.linalg.inv(v) if v is not None else v)
                               for k, v in prog["pose"].items()})
    out["answer_altered"] = cc.compare_answers(altered, want)
    unchanged = dict(prog, moved={k: {n: 0.0 for n in v} for k, v in prog["moved"].items()})
    out["state_unchanged"] = cc.compare_answers(unchanged, want)

    def halve(b):
        w = torch.zeros_like(b.weights)
        half = max(1, b.weights.shape[0] // 2)
        w[:half] = 1.0 / half
        return dataclasses.replace(b, weights=w)

    halved = dict(program, served={k: dict(c, batch=halve(c["batch"]))
                                   for k, c in program["served"].items()},
                  updates={u: dict(c, batch=halve(c["batch"]))
                           for u, c in program["updates"].items()})
    out["half_batch"] = cc.compare_answers(
        cc.reference_answers(halved, stream, cfg, seeds), want)
    sd = seeded_state_dict(seeds[2], cfg.depth_pose.scales, env.DEVICE,
                           *encoder_depths(vars(cfg.depth_pose)))

    def stale(c):
        if c["stale"] is None:
            return c
        old = sd if isinstance(c["stale"], str) else cc.unflat(c["stale"], program["shapes"])
        return dict(c, decoders={n: old[n].clone() for n in c["decoders"]})

    staled = dict(program, served={k: stale(c) for k, c in program["served"].items()})
    out["stale_served"] = cc.compare_answers(
        prog, cc.reference_answers(staled, stream, cfg, seeds))
    return out


def covio_look(kept: dict) -> dict:
    """The reference with bf16 convolutions against the float32 one, and the
    leaves of the kept updates with the widest change gaps on both sides."""
    import numpy as np

    from portbench.lib import covio_cell as cc

    program, stream, cfg, seeds, want = (kept[k] for k in ("program", "stream", "cfg", "seeds",
                                                           "want"))
    prog = cc.program_answers(program, stream)
    bf16 = cc.reference_answers(program, stream, cfg, seeds, precision="bf16")

    def leaves(side, count=3):
        rows = []
        for u, ref in want["moved"].items():
            grads = want["grad"][u]
            median = float(np.median(list(grads.values())))
            keep = [n for n in ref if grads.get(n, 0.0) >= 1e-3 * median]
            floor = float(np.median([ref[n] for n in keep]))
            sizes = program["updates"][u]["before"]["params"]
            rows += [[u, n, abs(side["moved"][u][n] - ref[n]) / max(ref[n], floor, 1e-30), ref[n],
                      side["moved"][u][n], sizes[n].numel(), grads[n] / median] for n in keep]
        return sorted(rows, key=lambda r: -r[2])[:count]

    return {"ref_bf16": cc.compare_answers(bf16, want), "leaves_program": leaves(prog),
            "leaves_ref_bf16": leaves(bf16)}


def pretrain_readings(kept: dict) -> dict:
    from portbench.lib import pretrain_cell as pc

    program, spec, seeds, want = (kept[k] for k in ("program", "spec", "seeds", "want"))
    out = {"control": pc.compare_answers(pc.reference_answers(program, spec, seeds, "tf32"),
                                         want, program)}
    prog = pc.program_answers(program)
    window = prog["window"]
    shifted = dict(prog, loss=[prog["loss"][0]] + prog["loss"][:-1],
                   window=[dict(w, loss=window[i - 1]["loss"]) for i, w in enumerate(window)])
    out["answer_altered"] = pc.compare_answers(shifted, want, program)
    still = [dict(w, moved={n: 0.0 for n in w["moved"]}, stats={n: 0.0 for n in w["stats"]})
             for w in window]
    out["state_unchanged"] = pc.compare_answers(dict(prog, after=want["start"], window=still),
                                                want, program)

    def halve(b):
        w = b["weights"].clone()
        half = w.shape[0] // 2
        w[half:] = 0.0
        w[:half] = 1.0 / half
        return dict(b, weights=w)

    halved = dict(program, batches=[halve(b) for b in program["batches"]],
                  window=[dict(c, batch=halve(c["batch"])) for c in program["window"]])
    out["half_batch"] = pc.compare_answers(pc.reference_answers(halved, spec, seeds), want,
                                           program)
    return out


def readings_for(config: dict, cell: dict) -> tuple:
    """(readings, look) of the cell's driver; look is None for pretraining."""
    if config["entry"] != "slam":
        return pretrain_readings, None
    from portbench.lib import slam_cell

    if slam_cell.driver(config, cell) is slam_cell:
        return slam_readings, slam_look
    return covio_readings, covio_look


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--look", action="store_true")
    p.add_argument("--override", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.lib import env, spec

    env.set_caches()
    cell = spec.cell(args.workload)
    if args.override:
        cell = dict(cell, overrides={**cell.get("overrides", {}), **json.loads(args.override)})
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    readings, look = readings_for(config, cell)
    if config["entry"] == "slam":
        from portbench.lib import slam_cell as driver
    else:
        from portbench.lib import pretrain_cell as driver
    rows = []
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run_args = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        res = driver.run(run_args, cell, config, traffic, {})
        row = {"seed": seed, "sound": res["numbers"], "failed": res["failed"],
               "e2e": res["e2e"], "setup_s": res["setup_s"]}
        if n < args.control_seeds:
            row.update(readings(res["kept"]))
        if args.look and look is not None:
            row.update(look(res["kept"]))
        del res
        env.free()
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row, default=float), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, default=float, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
