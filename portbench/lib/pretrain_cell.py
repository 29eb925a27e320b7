"""A pretraining cell: the program's `Pretrainer` at the configuration's
settings, trained on whole epochs of a pool of rendered frame triplets, each
sample colour-jittered and flipped on access and batched by the program's own
host batching and `Prefetcher`.  The window runs whole epochs until the
deadline, and ends with the last epoch's loss read and a synchronize.

Set-up: imports, the pool rendered from the seed, the networks with the
seeded weights, and a first epoch of three steps through the window's own
call (`Pretrainer.train_epoch`) and feed, which warms up every shape.

What `correct` compares, against `portbench/reference` (float32, TF32 off):
- the first three steps, from the seeded weights: each step's loss and the
  first's alone, the first gradient (from Adam's first moment after one
  step), each leaf's change after the three steps, the change of each batch
  norm's running statistics after the first step, and each input row byte
  for byte against what the pool served;
- steps of the window drawn from the seed: one reference step from the
  program's state just before the step (parameters, batch-norm statistics,
  Adam's moments, step and learning rate, the tie-break generator) on the
  batch the program trained on: the loss, each leaf's gradient (from Adam's
  first moment before and after), each leaf's change and each batch norm's
  statistics' change.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench.lib import compare, env, frames, stream as streams
from portbench.lib.trace import Spans, profile_slice


class Served:
    """The pool with a record of what it served, quantised as the program
    ships images (uint8)."""

    def __init__(self, pool):
        self.pool, self.rows = pool, []

    def __len__(self):
        return len(self.pool)

    def __getitem__(self, index):
        s = self.pool[index]
        self.rows.append([np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)
                          for a in (s.rgb, s.aug)])
        return s


class WindowSteps:
    """Wraps `train_step` as the `Pretrainer` calls it; for the steps drawn
    (counted from the window's first), keeps the batch, the losses and the
    program's state before and after the step, on the card."""

    def __init__(self, module, model, picks: set):
        self.model, self.picks, self.calls, self.kept = model, picks, 0, []
        self._module, self._real = module, module.train_step
        self.names = {id(p): n for n, p in model.named_parameters()}
        module.train_step = self._step

    def restore(self) -> None:
        self._module.train_step = self._real

    def _state(self, state) -> dict:
        opt = state.optimizer
        return {"params": {n: p.detach().clone() for n, p in self.model.named_parameters()},
                "stats": {n: b.detach().clone() for n, b in self.model.named_buffers()
                          if n.endswith(("running_mean", "running_var"))},
                "m": {self.names[id(p)]: s["exp_avg"].clone() for p, s in opt.state.items()},
                "v": {self.names[id(p)]: s["exp_avg_sq"].clone() for p, s in opt.state.items()},
                "t": max(int(s["step"]) for s in opt.state.values()),
                "lr": float(opt.param_groups[0]["lr"]),
                "rng": state.rng.get_state() if state.rng is not None else None}

    def _step(self, state, cfg, batch):
        k = self.calls
        self.calls += 1
        if k not in self.picks:
            return self._real(state, cfg, batch)
        before = self._state(state)
        losses = self._real(state, cfg, batch)
        self.kept.append({"step": k, "before": before, "after": self._state(state),
                          "loss": losses["loss"].clone(),
                          "batch": {f: getattr(batch, f).detach().clone()
                                    for f in ("rgb", "rgb_aug", "K", "rel_dist", "weights")}})
        return losses


def wrap_spans(spans: Spans, pool_cls) -> None:
    import tpuslam_torch.train.pretrain as pm
    from tpuslam_torch.data.base import Prefetcher

    spans.wrap(pm, "train_step", "steps.train_step")
    spans.wrap(pm, "make_frame_batch", "data.make_frame_batch")
    spans.wrap(pm.Pretrainer, "train_epoch", "entry.train_epoch")
    spans.wrap(Prefetcher, "__next__", "data.prefetch_wait")
    spans.wrap(pool_cls, "__getitem__", "data.sample")


def run(args, cell: dict, spec: dict, traffic: dict, result: dict) -> dict:
    t = time.perf_counter()
    import torch

    import tpuslam_torch.train.pretrain as pm
    from tpuslam_torch.models.depth_pose import DepthPoseNet

    from portbench.lib.weights import encoder_depths, seeded_state_dict

    setup = {"import_s": time.perf_counter() - t}
    if env.on_card():
        env.require_cards(cell["chips"])
        torch.cuda.init()
    seeds = [int(x) for x in np.random.SeedSequence(args.seed).generate_state(4)]
    run_cfg = spec["run"]["Pretrainer"]
    H, W, B = run_cfg["height"], run_cfg["width"], run_cfg["batch_size"]
    t = time.perf_counter()
    poses = frames.trajectory(traffic["trajectory"], traffic["pool_frames"], traffic["speed"],
                              seeds[0])
    images, _ = streams.render_parallel(poses, H, W, seeds[1], traffic["workers"])

    def pool(steps):
        return streams.TripletPool(poses, images, steps * B, seeds[3], traffic["flip"])

    setup["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    depths = encoder_depths(run_cfg)
    sd = seeded_state_dict(seeds[2], tuple(run_cfg["scales"]), env.DEVICE, *depths)
    with torch.device("meta"):
        model = DepthPoseNet(*depths, tuple(run_cfg["scales"]))
    model = model.to_empty(device=env.DEVICE)
    model.load_state_dict(sd)
    model.eval()
    del sd
    kwargs = {k: (tuple(v) if isinstance(v, list) else v) for k, v in run_cfg.items()}
    trainer = pm.Pretrainer(**kwargs, log_path=env.scratch_dir(cell["name"]) / "log",
                            device=env.DEVICE, model=model)
    setup["model_s"] = time.perf_counter() - t

    # the first epoch: three steps through the window's call and feed, kept
    t = time.perf_counter()
    kept, first_grad, first_stats = [], {}, {}
    names = {id(p): n for n, p in model.named_parameters()}
    own_step = pm.train_step

    def kept_step(state, cfg, batch):
        losses = own_step(state, cfg, batch)
        kept.append({"batch": batch, "losses": {k: v.clone() for k, v in losses.items()}})
        if not first_grad:
            for p, s in state.optimizer.state.items():
                first_grad[names[id(p)]] = s["exp_avg"].norm() / 0.1
            first_stats.update({n: b.detach().clone() for n, b in model.named_buffers()
                                if n.endswith(("running_mean", "running_var"))})
        return losses

    served = Served(pool(cell["check_steps"]))
    pm.train_step = kept_step
    try:
        trainer.train_epoch(served, progress=False)
    finally:
        pm.train_step = own_step
    env.sync()
    after = {n: t_.detach().clone() for n, t_ in model.state_dict().items()}
    setup["warmup_s"] = time.perf_counter() - t

    spans = None
    if args.trace:
        spans = Spans()
        wrap_spans(spans, streams.TripletPool)
    result["setup_s"] = env.process_seconds()
    epoch = pool(traffic["steps_per_epoch"])
    rng = np.random.default_rng(seeds[3])
    window = WindowSteps(pm, model, {int(rng.integers(lo, hi))
                                     for lo, hi in cell["check_window_steps"]})
    steps = failed = 0
    errors = []
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while time.perf_counter() < deadline:
        try:
            loss = trainer.train_epoch(epoch, progress=False)
            if not math.isfinite(loss):
                failed += traffic["steps_per_epoch"]
        except Exception as e:  # an epoch that raises fails its steps
            errors.append(f"{type(e).__name__}: {e}")
            failed += traffic["steps_per_epoch"]
        steps += traffic["steps_per_epoch"]
    env.sync()
    window_s = time.perf_counter() - t0
    window.restore()
    result.update(attempted=steps, failed=failed)
    result["e2e"] = {"pretrain_samples_per_s": steps * B / max(window_s, 1e-9)}
    print(f"window: {steps} steps of {B} in {window_s:.4f} s, {steps * B / window_s:.4f} "
          f"samples/s, {1e3 * window_s / max(steps, 1):.2f} ms/step; set-up "
          f"{result['setup_s']:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in setup.items())
          + ")", flush=True)
    for e in errors[:5]:
        print(f"failed: {e}", flush=True)

    result["run"] = {"kind": "pretrain", "cell": cell, "units": steps, "window_s": window_s,
                     "spec": spec, "settings": spec["run"], "spans": None, "slice": None}
    if args.trace:
        result["run"]["spans"] = {"total": dict(spans.total), "calls": dict(spans.calls)}
        spans.reset()
        count = cell["trace_slice"]
        sliced = pool(count)

        def run_units():
            trainer.train_epoch(sliced, progress=False)
            env.sync()
            return count

        result["run"]["slice"] = profile_slice(run_units, spans)
        spans.unwrap()
    result["memory_peak_bytes"] = env.peak_bytes()

    program = {"losses": [{k: float(v) for k, v in c["losses"].items()} for c in kept],
               "grad": {n: float(v) for n, v in first_grad.items()},
               "batches": [{f: getattr(c["batch"], f).detach().clone()
                            for f in ("rgb", "rgb_aug", "K", "rel_dist", "weights")}
                           for c in kept],
               "after": {n: v.float().cpu() for n, v in after.items()},
               "stats_first": {n: v.float().cpu() for n, v in first_stats.items()},
               "served": served.rows,
               "window": [dict(c, loss=float(c["loss"]),
                               before={k: _host(v) for k, v in c["before"].items()},
                               after={k: _host(v) for k, v in c["after"].items()})
                          for c in window.kept]}
    del trainer, model, kept, window
    env.free()
    want = reference_answers(program, spec, seeds)
    result["numbers"] = compare_answers(program_answers(program), want, program)
    result["kept"] = {"program": program, "spec": spec, "seeds": seeds, "want": want}
    return result


def _host(v):
    """A dict of tensors to the host as float32; anything else as it is."""
    if isinstance(v, dict):
        return {n: t.float().cpu() for n, t in v.items()}
    return v


def _ref_cfg(run_cfg: dict) -> dict:
    return {"scales": tuple(run_cfg["scales"]), "min_depth": run_cfg["min_depth"],
            "max_depth": run_cfg["max_depth"],
            "disparity_smoothness": run_cfg["disparity_smoothness"],
            "velocity_loss_scaling": run_cfg["velocity_loss_scaling"]}


def program_answers(program: dict) -> dict:
    window = [{"loss": c["loss"],
               # Adam's first moment moves as m = 0.9 m + 0.1 g
               "grad": {n: float(((m - 0.9 * c["before"]["m"][n]) / 0.1).norm())
                        for n, m in c["after"]["m"].items()},
               "moved": _moved(c["after"]["params"], c["before"]["params"]),
               "stats": _moved(c["after"]["stats"], c["before"]["stats"])}
              for c in program["window"]]
    return {"loss": [p["loss"] for p in program["losses"]], "grad": program["grad"],
            "after": program["after"], "stats_first": program["stats_first"], "window": window}


def _moved(after: dict, before: dict) -> dict:
    return {n: float((after[n] - before[n]).norm()) for n in before}


def _reference_net(run_cfg: dict, seeds):
    """The seeded weights and the reference's networks at the
    configuration's depths, loaded with them."""
    from portbench.lib.weights import encoder_depths, seeded_state_dict
    from portbench.reference import steps as ref

    depths = encoder_depths(run_cfg)
    sd = seeded_state_dict(seeds[2], tuple(run_cfg["scales"]), env.DEVICE, *depths)
    return sd, ref.build(sd, tuple(run_cfg["scales"]), env.DEVICE, "float32", *depths)


def reference_window(program: dict, spec: dict, seeds, precision: str = "float32") -> list:
    """One reference step from the program's state before each window step
    kept, on the program's batch."""
    import torch

    from portbench.reference import steps as ref

    run_cfg = spec["run"]["Pretrainer"]
    ref.no_tf32(precision != "tf32")
    sd, net = _reference_net(run_cfg, seeds)
    del sd
    params = dict(net.named_parameters())
    stats = {n: b for n, b in net.named_buffers() if n.endswith(("running_mean", "running_var"))}
    out = []
    for c in program["window"]:
        b = c["before"]
        with torch.no_grad():
            for group, side in ((params, b["params"]), (stats, b["stats"])):
                for n, t in group.items():
                    t.copy_(side[n])
        names = list(params)
        opt = ref.Adam([params[n] for n in names], b["lr"],
                       m=[b["m"][n].to(env.DEVICE) for n in names],
                       v=[b["v"][n].to(env.DEVICE) for n in names], t=b["t"])
        gen = None
        if b["rng"] is not None:
            gen = torch.Generator(device=env.DEVICE)
            gen.set_state(b["rng"])
        loss = float(ref.train_step(net, opt, c["batch"], _ref_cfg(run_cfg), gen)["loss"])
        out.append({"loss": loss, "grad": dict(zip(names, opt.first_grad_norms)),
                    "moved": {n: float((params[n].detach().cpu() - b["params"][n]).norm())
                              for n in names},
                    "stats": {n: float((t.cpu() - b["stats"][n]).norm())
                              for n, t in stats.items()}})
    return out


def reference_answers(program: dict, spec: dict, seeds, precision: str = "float32") -> dict:
    """Three reference steps from the seeded weights on the program's three
    batches (whose rows were held to what the pool served)."""
    import torch

    from portbench.reference import steps as ref

    run_cfg = spec["run"]["Pretrainer"]
    ref.no_tf32(precision != "tf32")
    sd, net = _reference_net(run_cfg, seeds)
    names = [n for n, _ in net.named_parameters()]
    opt = ref.Adam([p for _, p in net.named_parameters()], run_cfg["learning_rate"])
    gen = torch.Generator(device=env.DEVICE).manual_seed(run_cfg["seed"])
    losses, stats_first = [], {}
    for b in program["batches"]:
        losses.append(float(ref.train_step(net, opt, b, _ref_cfg(run_cfg), gen)["loss"]))
        if not stats_first:
            stats_first = {n: v.detach().float().cpu().clone() for n, v in net.state_dict().items()
                           if n.endswith(("running_mean", "running_var"))}
    return {"loss": losses, "grad": dict(zip(names, opt.first_grad_norms)),
            "after": {n: v.float().cpu() for n, v in net.state_dict().items()},
            "stats_first": stats_first,
            "start": {n: v.float().cpu() for n, v in sd.items()},
            "window": reference_window(program, spec, seeds, precision)}


def compare_answers(got: dict, want: dict, program: dict) -> dict:
    numbers = {"steps_checked": float(len(want["loss"]))}
    numbers["loss_gap"] = max(compare.rel_gap(a, b) for a, b in zip(got["loss"], want["loss"]))
    grads = want["grad"]
    median = float(np.median(list(grads.values())))
    moving = [n for n, g in grads.items() if g >= 1e-3 * median]
    numbers["grad_gap"] = compare.worst_leaf(got["grad"], grads, moving)
    numbers["grad_gap_median"] = compare.median_leaf(got["grad"], grads, moving)
    start = want["start"]

    def moved(side, keys):
        return {n: float((side[n] - start[n]).norm()) for n in keys}

    numbers["dparam_gap"] = compare.worst_leaf(moved(got["after"], moving),
                                               moved(want["after"], moving), moving)
    numbers["dparam_gap_median"] = compare.median_leaf(moved(got["after"], moving),
                                                       moved(want["after"], moving), moving)
    numbers["loss_gap_first"] = compare.rel_gap(got["loss"][0], want["loss"][0])
    stats = [n for n in start if n.endswith(("running_mean", "running_var"))]
    numbers["bn_gap"] = compare.worst_leaf(moved(got["after"], stats), moved(want["after"], stats),
                                           stats)
    # the first step's statistics, before Adam's steps amplify rounding
    numbers["bn_gap_first"] = compare.worst_leaf(moved(got["stats_first"], stats),
                                                 moved(want["stats_first"], stats), stats)
    mismatched = 0
    for b, batch in enumerate(program["batches"]):
        for r in range(batch["rgb"].shape[0]):
            rgb, aug = program["served"][b * batch["rgb"].shape[0] + r]
            mismatched += int((batch["rgb"][r].cpu().numpy() != rgb).sum()
                              + (batch["rgb_aug"][r].cpu().numpy() != aug).sum())
    numbers["input_rows"] = float(mismatched)
    # the window's steps, each from the program's state before it
    numbers["window_steps"] = float(len(want["window"]))
    gaps = {"window_loss_gap": [], "window_grad_gap": [], "window_dparam_gap": [],
            "window_bn_gap": []}
    for g, w in zip(got["window"], want["window"]):
        median = float(np.median(list(w["grad"].values())))
        moving = [n for n, v in w["grad"].items() if v >= 1e-3 * median]
        gaps["window_loss_gap"].append(compare.rel_gap(g["loss"], w["loss"]))
        gaps["window_grad_gap"].append(compare.worst_leaf(g["grad"], w["grad"], moving))
        gaps["window_dparam_gap"].append(compare.worst_leaf(g["moved"], w["moved"], moving))
        gaps["window_bn_gap"].append(compare.worst_leaf(g["stats"], w["stats"], w["stats"]))
    # no window step kept leaves these unmeasured (nan fails a limit)
    numbers.update({k: max(v, default=float("nan")) for k, v in gaps.items()})
    return numbers
