"""A SLAM cell in CoVIO's asynchronous mode (`async_adaptation`): each frame
is served by `eval_step` with the newest adopted weights, while one update
of K iterations runs behind it on a clone, on `Slam`'s side stream
(`consolidate_step_async`), and is adopted at the first frame that finds it
done (`Slam._adopt`).  `slam_cell` builds the cell and hands the frames
here.

Set-up runs the warm-up frames and ends in `finish_async()` and a
synchronize, so that the window starts with no update in flight; the window
ends the same way, so that the update in flight at its end is inside it.

What `correct` compares (against `portbench/reference`, float32, TF32 off),
for the first three frames served in set-up and two frames of the window
drawn from the seed, and for the first update of set-up and the update
launched at each drawn frame of the window (or at the next frame that
launches one):
- a served frame: its loss, its retired pose and its replay embedding
  against the reference's forward from the decoders it was served with;
- an update: each iteration's loss against the reference's forward from
  the decoders that iteration ran with, and the update's change of the
  decoders against the reference's K Adam steps from the source state's
  decoders, moments, step count and generator;
- this mode's own guarantees, exactly: a kept frame is served from the
  output of the last update adopted before it (the seeded decoders before
  the first adoption); every update runs K iterations; in the window, a
  frame that finds no update in flight after adoption launches one, and no
  frame launches one while one is in flight; the start (the first served
  frame and the first update from the seeded decoders) and the online row of
  each kept batch.

Copies of an update are made on the side stream inside it, and read after
its event; nothing is copied on the serving stream before that event.  Each
update's output is copied once on the side stream as one flat tensor, the
reading that the served decoders are held to.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np

from portbench.lib import compare, env
from portbench.lib import slam_cell as sc
from portbench.lib.trace import Spans, merge, overlap, profile_slice

DECODERS = ("depth_decoder.", "pose_decoder.")


def flat_decoders(model):
    """The decoders' parameters as one flat copy, in the model's order."""
    import torch

    return torch.cat([p.detach().reshape(-1) for n, p in model.named_parameters()
                      if n.startswith(DECODERS)])


def unflat(flat, shapes: Dict[str, tuple]) -> Dict[str, object]:
    """`flat_decoders`' copy split back into named tensors."""
    out, offset = {}, 0
    for n, shape in shapes.items():
        size = math.prod(shape)
        out[n] = flat[offset:offset + size].view(shape)
        offset += size
    return out


class AsyncCapture:
    """Wraps `eval_step`, `consolidate_step_async` (and, during it, the
    `consolidate_step` it runs on the clone) and the instance's `_adopt`, as
    `Slam` calls them.  Logs every serve, launch and adoption by the index of
    the frame served, counts each update's optimizer steps, and keeps, for
    the chosen frames and updates, what `reference_answers` reads."""

    def __init__(self, slam, slam_module, steps_module, served: set, window_frames: List[int]):
        self.slam, self.keep_served = slam, served
        self.wanted, self.met = sorted(window_frames), set()
        self.calls = 0
        self.events: List[tuple] = []  # (kind, frame, update)
        self.updates: List[dict] = []  # per launch: launch, adopt, steps, out
        self.adopted: List[Optional[int]] = []
        self.served: Dict[int, dict] = {}
        self.kept_updates: Dict[int, dict] = {}
        self.shapes: Dict[str, tuple] = {}
        self.side_stream = None
        self._slam_module, self._steps = slam_module, steps_module
        self._real_eval = slam_module.eval_step
        self._real_launch = slam_module.consolidate_step_async
        self._real_adopt = slam._adopt
        slam_module.eval_step = self._serve
        slam_module.consolidate_step_async = self._launch
        slam._adopt = self._adopt

    def restore(self) -> None:
        self._slam_module.eval_step = self._real_eval
        self._slam_module.consolidate_step_async = self._real_launch
        del self.slam._adopt

    def _out(self, i: int):
        """The output of the `i`-th adoption from the end (1 the last):
        the update's flat copy, "seeded" before the first one, None if
        there is no such adoption."""
        if i <= len(self.adopted):
            u = self.adopted[-i]
            return None if u is None else self.updates[u]["out"]
        return "seeded" if i == len(self.adopted) + 1 else None

    def _serve(self, model, cfg, batch, *args, **kwargs):
        k = self.calls
        self.calls += 1
        self.events.append(("serve", k, None))
        if k not in self.keep_served:
            return self._real_eval(model, cfg, batch, *args, **kwargs)
        decoders = sc.decoder_params(model)
        losses, outputs = self._real_eval(model, cfg, batch, *args, **kwargs)
        self.served[k] = {"step_id": self.slam.current_step, "batch": batch,
                          "decoders": decoders, "loss": losses["loss"].detach(),
                          "embedding": outputs[("embedding",)][0].detach(),
                          "expected": self._out(1), "stale": self._out(2)}
        return losses, outputs

    def _launch(self, state, cfg, batch, *args, **kwargs):
        u, frame = len(self.updates), self.calls - 1
        self.events.append(("launch", frame, u))
        record = {"launch": frame, "adopt": None, "steps": 0, "out": None}
        self.updates.append(record)
        self.side_stream = kwargs.get("stream", args[1] if len(args) > 1 else None)
        keep = u == 0
        for f in self.wanted:
            if f not in self.met and frame >= f:
                self.met.add(f)
                keep = True
        if not self.shapes:
            self.shapes = {n: tuple(p.shape) for n, p in state.model.named_parameters()
                           if n.startswith(DECODERS)}
        # the source state is the adopted one: the serving stream has waited
        # on its update's event, and the update in flight writes a clone
        kept = {"step_id": self.slam.current_step, "batch": batch,
                "before": sc.Capture._decoders(state), "iters": []} if keep else None
        real_inner = self._steps.consolidate_step

        def inner(clone, cfg_, batch_, num_steps, *a, **kw):  # on the side stream
            opt = clone.optimizer

            def step(*sa, **skw):
                record["steps"] += 1
                if kept is not None:
                    kept["iters"].append(sc.decoder_params(clone.model))
                return type(opt).step(opt, *sa, **skw)

            opt.step = step
            try:
                losses = real_inner(clone, cfg_, batch_, num_steps, *a, **kw)
            finally:
                del opt.step
            record["out"] = flat_decoders(clone.model)
            if kept is not None:
                kept.update(iter_losses=losses, after=sc.decoder_params(clone.model))
            return losses

        self._steps.consolidate_step = inner
        try:
            out = self._real_launch(state, cfg, batch, *args, **kwargs)
        finally:
            self._steps.consolidate_step = real_inner
        if kept is not None:
            self.kept_updates[u] = kept
        return out

    def _adopt(self):
        self._real_adopt()
        n = len(self.adopted)
        u = n if n < len(self.updates) else None  # one in flight: adopted in launch order
        self.adopted.append(u)
        self.events.append(("adopt", self.calls, u))
        if u is not None:
            self.updates[u]["adopt"] = self.calls
        if n >= 2 and self.adopted[n - 2] is not None:  # no frame can expect it any more
            self.updates[self.adopted[n - 2]]["out"] = None


def launch_violations(events, frames) -> int:
    """Frames among `frames` that broke the launch rule: found no update in
    flight after their adoption and launched none, or launched while one was
    in flight, or launched more than one."""
    launched = adopted = 0
    in_flight, launches = {}, {}
    for kind, frame, _ in events:
        if kind == "adopt":
            adopted += 1
        elif kind == "serve":
            in_flight[frame] = launched > adopted
        else:
            launches[frame] = launches.get(frame, 0) + 1
            launched += 1
    bad = 0
    for f in frames:
        n = launches.get(f, 0)
        busy = in_flight.get(f)
        bad += int(busy is None or (not busy and n == 0) or (busy and n > 0) or n > 1)
    return bad


def side_streams(slice_: dict, updates: int) -> Optional[dict]:
    """The side stream's busy time and its overlap with the serving
    stream's, in a slice that starts with a spin kernel on the side stream
    and then, after a synchronize, one on the serving stream."""
    streams = slice_.get("streams") or {}
    marks = sorted((s, sid) for sid, acts in streams.items() for s, _, n in acts
                   if "spin_kernel" in n)
    if len(marks) < 2 or marks[0][1] == marks[1][1]:
        return None
    side, serving = marks[0][1], marks[1][1]
    busy = [(s, e) for s, e, _ in streams[side]]
    serving_busy = [(s, e) for s, e, _ in streams[serving]]
    return {"updates": updates, "busy_s": sum(e - s for s, e in merge(busy)),
            "serving_busy_s": sum(e - s for s, e in merge(serving_busy)),
            "overlap_s": overlap(busy, serving_busy)}


def drive(slam, stream, cell: dict, seeds, args, result: dict, setup: dict) -> dict:
    """Set-up frames, the timed window and, with `--trace 1`, the profiled
    slice; fills `result` and returns what the program produced for the
    check, on the host or detached on the card."""
    import tpuslam_torch.slam.slam as slam_module
    import tpuslam_torch.train.steps as steps_module

    cfg = slam.config
    mirror = sc.OdometryMirror(slam.pose_graph)
    rng = np.random.default_rng(seeds[3])
    start = cell["warmup_frames"]
    window = [start + int(rng.integers(lo, hi)) for lo, hi in cell["check_window_frames"]]
    capture = AsyncCapture(slam, slam_module, steps_module, {0, 1, 2} | set(window), window)
    t = time.perf_counter()
    for k in range(start):
        slam.step(stream[k])
    slam.finish_async()
    env.sync()
    setup["warmup_s"] = time.perf_counter() - t
    setup_updates = len(capture.adopted)

    spans = None
    if args.trace:
        spans = Spans()
        sc.wrap_spans(spans)
    result["setup_s"] = env.process_seconds()
    depth = cfg.slam.pipeline_depth
    hand, back, errors = [], [], []
    k = start
    a0 = len(capture.adopted)
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
    slam.finish_async()
    flushed = time.perf_counter()
    env.sync()
    window_s = time.perf_counter() - t0
    n = len(hand)
    adopted = [u for u in capture.adopted[a0:] if u is not None]
    lags = [capture.updates[u]["adopt"] - capture.updates[u]["launch"] for u in adopted]
    latency = [(back[i + depth] if i + depth < n else flushed) - hand[i] for i in range(n)]
    retired = list(zip(slam.depth_loss[-n:], slam.velocity_loss[-n:]))
    failed = len(errors) + sum(1 for d, v in retired if not (math.isfinite(d) and math.isfinite(v)))
    result.update(attempted=n, failed=min(failed, n))
    updates = len(capture.adopted) - a0
    result["e2e"] = {"frames_per_s": n / window_s, "updates_per_s": updates / window_s}
    p90_ms = 1e3 * float(np.percentile(latency, 90))
    lag = float(np.median(lags)) if lags else None
    print(f"window: {n} frames in {window_s:.4f} s, {n / window_s:.4f} frames/s; {updates} "
          f"updates adopted, {updates / window_s:.4f} updates/s, lag median {lag} frames; "
          f"frame latency median {1e3 * float(np.median(latency)):.2f} ms, p90 {p90_ms:.2f} ms; "
          f"set-up {result['setup_s']:.2f} s ({setup_updates} updates adopted; "
          + ", ".join(f"{key} {v:.2f}" for key, v in setup.items()) + ")", flush=True)
    for e in errors[:5]:
        print(f"failed: {e}", flush=True)

    result["run"] = {"kind": "slam", "cell": cell, "units": n, "window_s": window_s,
                     "frame_ms_p90": p90_ms, "updates": updates, "update_lag_frames": lag,
                     "spans": None, "slice": None}
    if args.trace:
        result["run"]["spans"] = {"total": dict(spans.total), "calls": dict(spans.calls)}
        spans.reset()
        count = cell["trace_slice"]
        launched = len(capture.updates)

        def run_units():
            nonlocal k
            if env.on_card():  # mark the two streams, side first
                import torch

                with torch.cuda.stream(capture.side_stream):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
                torch.cuda._sleep(1)
            for _ in range(count):
                slam.step(stream[k])
                k += 1
            env.sync()
            return count

        sl = profile_slice(run_units, spans, streams=True)
        sl["side"] = side_streams(sl, len(capture.updates) - launched)
        del sl["streams"]
        result["run"]["slice"] = sl
        slam.finish_async()
        env.sync()
        spans.unwrap()
    result["memory_peak_bytes"] = env.peak_bytes()

    capture.restore()
    for c in capture.served.values():
        c["odometry"] = mirror.edges.get(c["step_id"])
    window_frames = range(start, start + n)
    return {"served": capture.served, "updates": capture.kept_updates, "shapes": capture.shapes,
            "steps": [u["steps"] for u in capture.updates],
            "iterations": cfg.slam.adaptation_epochs,
            "launch_rule": launch_violations(capture.events, window_frames)}


def program_answers(program: dict, stream) -> dict:
    """The program's answers in the form `reference_answers` gives them."""
    import torch

    out = {"serve_loss": {}, "pose": {}, "embedding": {}, "update_loss": {}, "moved": {},
           "online_row": 0.0, "launch_rule": float(program["launch_rule"]),
           "update_iters": float(max((abs(s - program["iterations"]) for s in program["steps"]),
                                     default=float("nan")))}

    def online_row(batch, step_id):
        want = torch.from_numpy(stream.rgb(step_id - 1)).to(batch.rgb.device)
        return float((batch.rgb[0] != want).sum() + (batch.rgb_aug[0] != want).sum())

    for k, c in program["served"].items():
        out["serve_loss"][k] = float(c["loss"])
        out["pose"][k] = c["odometry"]
        out["embedding"][k] = c["embedding"].float().cpu().numpy()
        out["online_row"] += online_row(c["batch"], c["step_id"])
    for u, c in program["updates"].items():
        out["update_loss"][u] = c["iter_losses"].double().cpu().numpy()
        out["moved"][u] = {n: float((c["after"][n] - c["before"]["params"][n]).norm())
                           for n in c["before"]["params"]}
        out["online_row"] += online_row(c["batch"], c["step_id"])
    return out


def reference_answers(program: dict, stream, cfg, seeds, precision: str = "float32") -> dict:
    """The reference's answers to the same inputs: each kept frame's forward
    from the decoders it was served with, each kept update step by step from
    its source state, and the served decoders held to the adopted ones."""
    import torch

    from portbench.reference import steps as ref

    net = sc.reference_net(cfg, seeds, precision)
    rcfg = sc._ref_cfg(cfg)
    if precision == "control":  # the warp stored one type below the configuration's
        rcfg["warp_storage"] = "fp8" if cfg.depth_pose.pallas_bf16_out else "bf16"
    params = dict(net.named_parameters())
    dec = [n for n, p in params.items() if p.requires_grad]
    seeded = {n: params[n].detach().clone() for n in dec}
    served, updates = program["served"], program["updates"]
    lr, iters = cfg.depth_pose.learning_rate, cfg.slam.adaptation_epochs
    out = {"serve_loss": {}, "pose": {}, "embedding": {}, "update_loss": {}, "moved": {},
           "grad": {}}

    def gap(got: dict, want) -> float:
        want = seeded if isinstance(want, str) else unflat(want, program["shapes"])
        return max((float((got[n] - want[n]).abs().max()) if n in want else float("nan"))
                   for n in dec)

    firsts = [served[min(served)]["decoders"], updates[min(updates)]["before"]["params"]]
    out["start_gap"] = max(gap(first, "seeded") for first in firsts)
    out["served_state_gap"] = max(gap(c["decoders"], c["expected"]) if c["expected"] is not None
                                  else float("nan") for c in served.values())

    def generator(before):
        if before["rng"] is None:
            return None
        gen = torch.Generator(device=env.DEVICE)
        gen.set_state(before["rng"])
        return gen

    def load(weights):
        with torch.no_grad():
            for n in dec:
                params[n].copy_(weights[n])

    for k in sorted(served):
        c = served[k]
        load(c["decoders"])
        losses, T01, emb = ref.serve_frame(net, sc._batch(c["batch"]), rcfg)
        out["serve_loss"][k] = float(losses["loss"])
        out["pose"][k] = np.linalg.inv(T01.double().cpu().numpy())
        out["embedding"][k] = emb.float().cpu().numpy()
    for u in sorted(updates):
        c = updates[u]
        before, batch = c["before"], sc._batch(c["batch"])
        # each iteration's forward from the decoders the update ran it with
        losses, _, out["grad"][u] = ref.stagewise(net, batch, rcfg, c["iters"],
                                                  generator(before))
        out["update_loss"][u] = losses.double().cpu().numpy()
        # the update's K steps of Adam from its source state
        load(before["params"])
        zeros = [torch.zeros_like(params[n]) for n in dec]
        opt = ref.Adam([params[n] for n in dec], lr,
                       m=[before["m"].get(n, z) for n, z in zip(dec, zeros)],
                       v=[before["v"].get(n, z) for n, z in zip(dec, zeros)],
                       t=before["t"].get(dec[0], 0))
        ref.adapt_frame(net, opt, batch, rcfg, iters, generator(before))
        out["moved"][u] = {n: float((params[n].detach() - before["params"][n]).norm())
                           for n in dec}
    return out


def compare_answers(got: dict, want: dict) -> dict:
    """The numbers compared, from two sets of answers."""
    numbers = {"frames_checked": float(len(want["serve_loss"])),
               "updates_checked": float(len(want["update_loss"]))}
    numbers["serve_loss_gap"] = max((compare.rel_gap(got["serve_loss"][k], want["serve_loss"][k])
                                     for k in want["serve_loss"]), default=0.0)
    numbers["pose_gap"] = max((compare.pose_gap(got["pose"][k], want["pose"][k])
                               if got["pose"][k] is not None else float("nan")
                               for k in want["pose"]), default=0.0)
    numbers["embed_gap"] = max((float(np.abs(got["embedding"][k] - want["embedding"][k]).max())
                                for k in want["embedding"]), default=0.0)
    numbers["update_loss_gap"] = max(
        (compare.rel_gap(a, b) if len(got["update_loss"][u]) == len(want["update_loss"][u])
         else float("nan") for u in want["update_loss"]
         for a, b in zip(got["update_loss"][u], want["update_loss"][u])), default=0.0)

    def median_gap(u):
        grads = want["grad"][u]
        median = float(np.median(list(grads.values())))
        moving = [n for n, g in grads.items() if g >= 1e-3 * median]
        return compare.median_leaf(got["moved"][u], want["moved"][u], moving)

    numbers["update_dparam_gap_median"] = max((median_gap(u) for u in want["moved"]),
                                              default=0.0)
    numbers["served_state_gap"] = want["served_state_gap"]
    numbers["update_iters"] = got.get("update_iters", 0.0)
    numbers["launch_rule"] = got.get("launch_rule", 0.0)
    numbers["online_row"] = got.get("online_row", 0.0)
    numbers["start_gap"] = want["start_gap"]
    return numbers
