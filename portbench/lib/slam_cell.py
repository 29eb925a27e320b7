"""A SLAM cell: `Slam` built from the cell's configuration, fed a rendered
camera stream in a closed loop (the next frame is handed over as soon as
`Slam.step` returns), timed over a window that ends with `flush_pipeline()`
and a synchronize.

Set-up: imports, the program's kernel libraries, the stream rendered from the
seed, `Slam` with the seeded weights, then the cell's warm-up frames through
`Slam.step` (cuDNN's first calls, the replay buffer), a flush and a
synchronize.

A frame's latency runs from its hand-over to `Slam.step` to the return of the
public call that retires it: with `pipeline_depth` N, `step(t + N)`, or the
closing `flush_pipeline()` for the last N frames.

With `async_adaptation` on (CoVIO's asynchronous mode) the frames are driven
and checked by `covio_cell` instead, after the same set-up.

What `correct` compares (against `portbench/reference`, float32, TF32 off):
the first three adapted frames of set-up and two frames of the window drawn
from the seed.  The reference follows the program step by step from the
program's own state, which the program alone holds: each iteration's forward
from the decoders that iteration ran with (its loss; the last one's pose,
held to the pose the frame retired; the first frame's first gradient), the
frame's K Adam steps from the decoders, Adam's moments and the tie-break
generator before it (the decoders' change), and the frozen encoder (the
replay embedding).  The start is checked by itself: the first frame's
decoders are the seeded ones, and the online row of each batch is the
stream's, byte for byte.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict

import numpy as np

from portbench.lib import compare, env, frames, stream as streams
from portbench.lib.trace import Spans, profile_slice


def settings(spec: dict, cell: dict) -> dict:
    """The configuration's `run` sections with the cell's `overrides`."""
    run = {k: dict(v) for k, v in spec["run"].items()}
    for section, values in cell.get("overrides", {}).items():
        run.setdefault(section, {}).update(values)
    return run


def port_config(spec: dict, cell: dict, log_dir):
    """The program's Config from `settings`, with the logs under `log_dir`."""
    import json

    from tpuslam_torch.config import parse_config

    run = settings(spec, cell)
    run["DepthPosePrediction"]["log_path"] = str(log_dir / "log")
    path = log_dir / "config.yaml"
    path.write_text(json.dumps(run))
    return parse_config(path)


class Capture:
    """Wraps `adapt_step` as `Slam` calls it; keeps, for the chosen frames,
    the batch, the outputs, the decoders and Adam's state before and after,
    the decoders each iteration ran with (before each optimizer step) and,
    at the first frame, the first gradient as Adam's first moment holds it."""

    def __init__(self, slam, module, frames: set):
        self.slam, self.frames = slam, frames
        self.calls, self.kept, self.first_grad = 0, {}, {}
        self._module = module
        self._real = module.adapt_step
        module.adapt_step = self._step

    def restore(self) -> None:
        self._module.adapt_step = self._real

    @staticmethod
    def _decoders(state) -> Dict[str, object]:
        model, opt = state.model, state.optimizer
        names = {id(p): n for n, p in model.named_parameters()}
        return {"params": decoder_params(model),
                "m": {names[id(p)]: s["exp_avg"].clone() for p, s in opt.state.items()},
                "v": {names[id(p)]: s["exp_avg_sq"].clone() for p, s in opt.state.items()},
                "t": {names[id(p)]: int(s["step"]) for p, s in opt.state.items()},
                "rng": state.rng.get_state() if state.rng is not None else None}

    def _step(self, state, cfg, batch, *args, **kwargs):
        k = self.calls
        self.calls += 1
        if k not in self.frames:
            return self._real(state, cfg, batch, *args, **kwargs)
        before = self._decoders(state)
        opt, iters = state.optimizer, []
        names = {id(p): n for n, p in state.model.named_parameters()}

        def step(*a, **kw):  # the optimizer's own step, with the weights it starts from
            iters.append(decoder_params(state.model))
            out = type(opt).step(opt, *a, **kw)
            if not self.first_grad:
                self.first_grad.update({names[id(p)]: float(s["exp_avg"].norm() / 0.1)
                                        for p, s in opt.state.items()})
            return out

        opt.step = step
        try:
            losses, outputs = self._real(state, cfg, batch, *args, **kwargs)
        finally:
            del opt.step
        self.kept[k] = {
            "step_id": self.slam.current_step, "batch": batch, "before": before,
            "iters": iters, "iter_losses": losses["iter_losses"],
            "embedding": outputs[("embedding",)][0].detach(), "after": self._decoders(state)}
        return losses, outputs


def decoder_params(model) -> Dict[str, object]:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith(("depth_decoder.", "pose_decoder."))}


class OdometryMirror:
    """Records the odometry edge each retired frame adds to the pose graph."""

    def __init__(self, graph):
        self.edges = {}
        add_edge = graph.add_edge

        def edge(vertices, measurement, information=None, is_loop_closure=False):
            i, j = vertices
            if j == i + 1 and not is_loop_closure:
                self.edges[j] = np.array(measurement, np.float64)
            return add_edge(vertices, measurement, information, is_loop_closure)

        graph.add_edge = edge


def wrap_spans(spans: Spans) -> None:
    import tpuslam_torch.slam.slam as sm
    from tpuslam_torch.loopclosure.detection import LoopClosureDetection
    from tpuslam_torch.memory.replay_buffer import ReplayBuffer
    from tpuslam_torch.posegraph.graph import PoseGraph

    for name in ("adapt_step", "eval_step", "embed", "predict_pose_step",
                 "consolidate_step_async"):
        spans.wrap(sm, name, f"steps.{name}")
    spans.wrap(sm, "make_frame_batch", "data.make_frame_batch")
    spans.wrap(sm.Slam, "step", "entry.step")
    spans.wrap(sm.Slam, "_retire", "entry.retire")
    spans.wrap(ReplayBuffer, "add", "data.replay_add")
    spans.wrap(ReplayBuffer, "get", "data.replay_get")
    spans.wrap(LoopClosureDetection, "add", "lc.index_add")
    spans.wrap(LoopClosureDetection, "search", "lc.search")
    spans.wrap(PoseGraph, "optimize", "pg.optimize")


def run(args, cell: dict, spec: dict, traffic: dict, result: dict) -> dict:
    t = time.perf_counter()
    import torch

    import tpuslam_torch.slam.slam as slam_module
    from tpuslam_torch.ops import build, reproj, warp
    from tpuslam_torch.posegraph import native

    from portbench.lib.weights import encoder_depths, seeded_state_dict

    setup = {"import_s": time.perf_counter() - t}
    t = time.perf_counter()
    if env.on_card():
        env.require_cards(cell["chips"])
        build.build_kernels()
        warp.load_library()
        reproj.load_library()
        torch.cuda.init()
    native.is_available()
    setup["libraries_s"] = time.perf_counter() - t

    seeds = [int(x) for x in np.random.SeedSequence(args.seed).generate_state(4)]
    t = time.perf_counter()
    stream = make_stream(spec, traffic, seeds)
    setup["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg = port_config(spec, cell, env.scratch_dir(cell["name"]))
    slam = slam_module.Slam(cfg, dataset=stream, device=env.DEVICE)
    setup["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    slam.state.model.load_state_dict(seeded_state_dict(
        seeds[2], cfg.depth_pose.scales, env.DEVICE, *encoder_depths(vars(cfg.depth_pose))))
    setup["weights_s"] = time.perf_counter() - t
    mode = driver(spec, cell)
    program = mode.drive(slam, stream, cell, seeds, args, result, setup)
    result["run"].update(spec=spec, settings=settings(spec, cell))
    del slam
    env.free()
    want = mode.reference_answers(program, stream, cfg, seeds)
    result["numbers"] = mode.compare_answers(mode.program_answers(program, stream), want)
    result["kept"] = {"program": program, "stream": stream, "cfg": cfg, "seeds": seeds,
                      "want": want}
    return result


def driver(spec: dict, cell: dict):
    """The module that drives and checks the frames: this one, or
    `covio_cell` where the settings turn `async_adaptation` on."""
    if settings(spec, cell)["Slam"].get("async_adaptation"):
        from portbench.lib import covio_cell

        return covio_cell
    return sys.modules[__name__]


def make_stream(spec: dict, traffic: dict, seeds):
    ds = spec["run"]["Dataset"]
    poses = frames.trajectory(traffic["trajectory"], traffic["rendered_frames"], traffic["speed"],
                              seeds[0])
    images, depths = streams.render_parallel(poses, ds["height"], ds["width"], seeds[1],
                                             traffic["workers"])
    return streams.DriveStream(poses, images, depths)


def drive(slam, stream, cell: dict, seeds, args, result: dict, setup: dict) -> dict:
    """Set-up frames, the timed window and, with `--trace 1`, the profiled
    slice; fills `result` and returns what the program produced for the
    check, on the host or detached on the card."""
    import tpuslam_torch.slam.slam as slam_module

    cfg = slam.config
    mirror = OdometryMirror(slam.pose_graph)
    rng = np.random.default_rng(seeds[3])
    start = cell["warmup_frames"]
    capture = Capture(slam, slam_module, {0, 1, 2} | {
        start + int(rng.integers(lo, hi)) for lo, hi in cell["check_window_frames"]})
    t = time.perf_counter()
    for k in range(start):
        slam.step(stream[k])
    slam.flush_pipeline()
    env.sync()
    setup["warmup_s"] = time.perf_counter() - t

    spans = None
    if args.trace:
        spans = Spans()
        wrap_spans(spans)
    result["setup_s"] = env.process_seconds()
    depth = cfg.slam.pipeline_depth
    hand, back, errors = [], [], []
    k = start
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while time.perf_counter() < deadline:
        sample = stream[k]
        hand.append(time.perf_counter())
        try:
            slam.step(sample)
        except Exception as e:  # a frame that raises is a failed frame
            errors.append(f"frame {k}: {type(e).__name__}: {e}")
        back.append(time.perf_counter())
        k += 1
    slam.flush_pipeline()
    flushed = time.perf_counter()
    env.sync()
    window_s = time.perf_counter() - t0
    n = len(hand)
    latency = [(back[i + depth] if i + depth < n else flushed) - hand[i] for i in range(n)]
    retired = list(zip(slam.depth_loss[-n:], slam.velocity_loss[-n:]))
    failed = len(errors) + sum(1 for d, v in retired if not (math.isfinite(d) and math.isfinite(v)))
    result.update(attempted=n, failed=min(failed, n))
    result["e2e"] = {"frames_per_s": n / window_s}
    p90_ms = 1e3 * float(np.percentile(latency, 90))
    print(f"window: {n} frames in {window_s:.4f} s, {n / window_s:.4f} frames/s; frame latency "
          f"median {1e3 * float(np.median(latency)):.2f} ms, p90 "
          f"{p90_ms:.2f} ms; set-up {result['setup_s']:.2f} s ("
          + ", ".join(f"{key} {v:.2f}" for key, v in setup.items()) + ")", flush=True)
    for e in errors[:5]:
        print(f"failed: {e}", flush=True)

    result["run"] = {"kind": "slam", "cell": cell, "units": n, "window_s": window_s,
                     "frame_ms_p90": p90_ms, "spans": None, "slice": None}
    if args.trace:
        result["run"]["spans"] = {"total": dict(spans.total), "calls": dict(spans.calls)}
        spans.reset()
        count = cell["trace_slice"]

        def run_units():
            nonlocal k
            for _ in range(count):
                slam.step(stream[k])
                k += 1
            env.sync()
            return count

        result["run"]["slice"] = profile_slice(run_units, spans)
        slam.flush_pipeline()
        env.sync()
        spans.unwrap()
    result["memory_peak_bytes"] = env.peak_bytes()

    capture.restore()
    for c in capture.kept.values():
        c["odometry"] = mirror.edges.get(c["step_id"])
    return {"first_grad": capture.first_grad, "kept": capture.kept}


def _ref_cfg(cfg) -> dict:
    pc = cfg.depth_pose
    return {"scales": tuple(pc.scales), "min_depth": pc.min_depth, "max_depth": pc.max_depth,
            "disparity_smoothness": pc.disparity_smoothness,
            "velocity_loss_scaling": pc.velocity_loss_scaling}


def _batch(fb) -> dict:
    return {"rgb": fb.rgb, "rgb_aug": fb.rgb_aug, "K": fb.K, "rel_dist": fb.rel_dist,
            "weights": fb.weights}


def program_answers(program: dict, stream) -> dict:
    """The program's answers in the form `reference_answers` gives them."""
    import torch

    out = {"loss": {}, "pose": {}, "embedding": {}, "moved": {}, "grad": program["first_grad"],
           "online_row": 0.0}
    for i, c in program["kept"].items():
        out["loss"][i] = c["iter_losses"].double().cpu().numpy()
        out["pose"][i] = c["odometry"]
        out["embedding"][i] = c["embedding"].float().cpu().numpy()
        out["moved"][i] = {n: float((c["after"]["params"][n] - c["before"]["params"][n]).norm())
                           for n in c["before"]["params"]}
        want = torch.from_numpy(stream.rgb(c["step_id"] - 1)).to(c["batch"].rgb.device)
        out["online_row"] += float((c["batch"].rgb[0] != want).sum()
                                   + (c["batch"].rgb_aug[0] != want).sum())
    return out


def reference_net(cfg, seeds, precision: str = "float32"):
    """The reference's networks from the seeded weights, decoders trainable.
    `precision` "control": the reference one step below the configuration,
    fp8 convolutions for its bf16 ones and the warp stored one type below
    the configuration's storage; "bf16": bf16 convolutions (a look at what
    rounding alone does)."""
    from portbench.lib.weights import encoder_depths, seeded_state_dict
    from portbench.reference import steps as ref

    ref.no_tf32(True)
    depths = encoder_depths(vars(cfg.depth_pose))
    sd = seeded_state_dict(seeds[2], cfg.depth_pose.scales, env.DEVICE, *depths)
    net = ref.build(sd, cfg.depth_pose.scales, env.DEVICE,
                    {"control": "fp8"}.get(precision, precision), *depths)
    for n, p in net.named_parameters():
        p.requires_grad_(n.startswith(("depth_decoder.", "pose_decoder.")))
    return net


def reference_answers(program: dict, stream, cfg, seeds, precision: str = "float32") -> dict:
    """The reference's answers to the same inputs: the adapting frames step
    by step from the program's state (see the module's docstring)."""
    import torch

    from portbench.reference import steps as ref

    net = reference_net(cfg, seeds, precision)
    rcfg = _ref_cfg(cfg)
    if precision == "control":  # the warp stored one type below the configuration's
        rcfg["warp_storage"] = "fp8" if cfg.depth_pose.pallas_bf16_out else "bf16"
    params = dict(net.named_parameters())
    dec = [n for n, p in params.items() if p.requires_grad]
    out = {"loss": {}, "pose": {}, "embedding": {}, "moved": {}, "grad": {}}
    kept = program["kept"]
    lr, iters = cfg.depth_pose.learning_rate, cfg.slam.adaptation_epochs
    first = kept[min(kept)]["before"]["params"]
    out["start_gap"] = max(float((first[n] - params[n].detach()).abs().max()) for n in dec)

    def generator(before):
        if before["rng"] is None:
            return None
        gen = torch.Generator(device=env.DEVICE)
        gen.set_state(before["rng"])
        return gen

    for i in sorted(kept):
        c = kept[i]
        before, batch = c["before"], _batch(c["batch"])
        # each iteration's forward from the decoders the program ran it with
        losses, T01, grads = ref.stagewise(net, batch, rcfg, c["iters"], generator(before))
        out["loss"][i] = losses.double().cpu().numpy()
        out["pose"][i] = np.linalg.inv(T01.double().cpu().numpy())
        if i == min(kept):
            out["grad"] = grads
        # the frame's K steps of Adam from the program's state before it
        with torch.no_grad():
            for n in dec:
                params[n].copy_(before["params"][n])
        zeros = [torch.zeros_like(params[n]) for n in dec]
        opt = ref.Adam([params[n] for n in dec], lr,
                       m=[before["m"].get(n, z) for n, z in zip(dec, zeros)],
                       v=[before["v"].get(n, z) for n, z in zip(dec, zeros)],
                       t=before["t"].get(dec[0], 0))
        _, _, emb = ref.adapt_frame(net, opt, batch, rcfg, iters, generator(before))
        out["embedding"][i] = emb.float().cpu().numpy()
        out["moved"][i] = {n: float((params[n].detach() - before["params"][n]).norm())
                           for n in dec}
    return out


def compare_answers(got: dict, want: dict) -> dict:
    """The numbers compared, from two sets of answers."""
    grads = want["grad"]
    numbers = {"frames_checked": float(len(want["loss"]))}
    numbers["loss_gap"] = max((compare.rel_gap(a, b) for k in want["loss"]
                               for a, b in zip(got["loss"][k], want["loss"][k])), default=0.0)
    numbers["loss_gap_first"] = max((compare.rel_gap(got["loss"][k][0], want["loss"][k][0])
                                     for k in want["loss"]), default=0.0)
    numbers["pose_gap"] = max((compare.pose_gap(got["pose"][k], want["pose"][k])
                               if got["pose"][k] is not None else float("nan")
                               for k in want["pose"]), default=0.0)
    numbers["embed_gap"] = max((float(np.abs(got["embedding"][k] - want["embedding"][k]).max())
                                for k in want["embedding"]), default=0.0)
    median = float(np.median(list(grads.values())))
    moving = [n for n, g in grads.items() if g >= 1e-3 * median]
    numbers["grad_gap"] = compare.worst_leaf(got["grad"], grads, moving)
    numbers["grad_gap_median"] = compare.median_leaf(got["grad"], grads, moving)
    numbers["dparam_gap"] = max(compare.worst_leaf(got["moved"][k], want["moved"][k], moving)
                                for k in want["moved"])
    numbers["dparam_gap_median"] = max(compare.median_leaf(got["moved"][k], want["moved"][k],
                                                           moving) for k in want["moved"])
    numbers["online_row"] = got.get("online_row", 0.0)
    numbers["start_gap"] = want["start_gap"]
    return numbers
