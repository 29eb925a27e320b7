"""Tracing and profiling hooks.

Counterpart of `tpuslam/utils/profiling.py`:

- `trace`: a context manager around `torch.profiler` that writes a Chrome
  trace of the host and, on the card, of the device into `log_dir`, with
  the program's tracer (`tpuslam_torch.tracing`) on for its block;
  `by_span` reduces such a trace to the device's time by the program's
  spans (`reduce_by_span` on plain tuples).
- `MetricsLogger`: an append-only JSONL metrics log, mirrored to wandb when
  that is installed (imported only when asked for).
- `profile_host_pipeline`, `profile_sync_latency`, `profile_adapt_step`:
  the host feed of the SLAM loop, the cost of the per-frame readback, and
  the fixed / per-iteration split of `adapt_step` by a K-sweep.

Device times are taken with `torch.cuda.Event`s and a `synchronize` on the
card; on the CPU the host clock times the same calls (a CPU number is the
speed of PyTorch's CPU kernels, not of the card).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpuslam_torch import resolve_device, tracing
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.train.batch import concat_batches, make_frame_batch
from tpuslam_torch.train.state import TrainState, make_adapt_optimizer, make_train_state
from tpuslam_torch.train.steps import LossConfig, adapt_step


@contextlib.contextmanager
def trace(log_dir: Path, enabled: bool = True):
    """Profile the block with `torch.profiler` (host, and the device when
    CUDA is available) and write `log_dir/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto).  The program's tracer is on for the block
    (and off after it, unless it was on before), so the trace holds the
    program's spans as `tracing.PREFIX` ranges, those of every thread (the
    `Prefetcher`'s too), and `tracing.snapshot()` sums them up;
    `by_span(prof)` gives the device's time by span.  Yields the profiler,
    or None when not enabled."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    was_on = tracing.on
    tracing.enable()
    try:
        every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        with torch.profiler.profile(activities=activities,
                                    experimental_config=every_thread) as prof:
            yield prof
    finally:
        if not was_on:
            tracing.disable()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _nested(ranges):
    """One thread's ranges (start, end, name), sorted by start, with the
    index of each one's enclosing range (-1 for none)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    parent, open_ = [], []
    for i, (start, _, _) in enumerate(ranges):
        while open_ and ranges[open_[-1]][1] <= start:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)
    return ranges, [r[0] for r in ranges], parent


def _innermost(nested, t: float):
    """The innermost range of one thread's `_nested` ranges open at time t."""
    ranges, starts, parent = nested
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and ranges[i][1] < t:
        i = parent[i]
    return ranges[i] if i >= 0 else None


def reduce_by_span(device, launches, ranges, min_gap_us: float = 10.0) -> dict:
    """A profiler's trace by the host ranges around its device work, from
    plain tuples (times in microseconds, names with their prefix):

    - `device`: the device's activities (start, end, name, correlation id);
    - `launches`: correlation id -> (time, thread) of the call that
      launched the activity;
    - `ranges`: host ranges (start, end, name, thread): the program's spans
      (`tracing.PREFIX`) and any other annotation.

    Each activity is given to the innermost program span open when its
    launch was made, on the thread that made it, or, where that thread has
    none open (autograd launches the backward from a thread of its own), to
    the innermost open then on any thread that launches device work.  Each
    gap of more than `min_gap_us` between activities is given to the
    innermost range of either kind open at its middle on a launching thread.
    Returns {"device_by_span": {span: s}, "launches_by_span": {span: n},
    "idle_by_span": {range: s}}, names without their prefix; work outside
    any span is "outside the spans"."""
    outside = "outside the spans"
    launching = {thread for _, thread in launches.values()}
    every, program = defaultdict(list), defaultdict(list)
    for start, end, name, thread in ranges:
        every[thread].append((start, end, name.split(":", 1)[-1]))
        if name.startswith(tracing.PREFIX):
            program[thread].append((start, end, name[len(tracing.PREFIX):]))
    every = {t: _nested(r) for t, r in every.items()}
    program = {t: _nested(r) for t, r in program.items()}

    def innermost(nested, t: float, thread=None):
        if thread in nested:
            found = _innermost(nested[thread], t)
            if found is not None:
                return found[2]
        found = [r for r in (_innermost(nested[k], t) for k in launching if k in nested)
                 if r is not None]
        return min(found, key=lambda r: r[1] - r[0])[2] if found else outside

    device_s, count = Counter(), Counter()
    for start, end, _, corr in device:
        launch = launches.get(corr)
        name = innermost(program, *launch) if launch is not None else outside
        device_s[name] += (end - start) / 1e6
        count[name] += 1
    idle = Counter()
    activity = sorted((start, end) for start, end, _, _ in device)
    last = activity[0][1] if activity else 0.0
    for start, end in activity[1:]:
        if start > last + min_gap_us:
            idle[innermost(every, 0.5 * (start + last))] += (start - last) / 1e6
        elif start > last:
            idle[f"gaps under {min_gap_us:g} us"] += (start - last) / 1e6
        last = max(last, end)
    return {"device_by_span": dict(device_s), "launches_by_span": dict(count),
            "idle_by_span": dict(idle)}


def by_span(prof, annotations=(tracing.PREFIX,)) -> dict:
    """`reduce_by_span` over the events of a finished `torch.profiler`
    profile: its device activities, the runtime calls that launched them
    (matched by correlation id), and its host ranges whose names start with
    one of `annotations` (the program's spans and, say, a harness's own)."""
    from torch.autograd import DeviceType

    events = prof.events()
    device, ranges = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # record_function ranges (the program's, the optimizer's, the
            # profiler's steps) show on the device's timeline too
            if not getattr(e, "is_user_annotation", False) and \
                    not e.name.startswith(annotations + ("Optimizer.", "ProfilerStep")):
                device.append((e.time_range.start, e.time_range.end, e.name, e.id))
        elif e.name.startswith(annotations):
            ranges.append((e.time_range.start, e.time_range.end, e.name, e.thread))
    ids = {d[3] for d in device}
    launches = {e.id: (e.time_range.start, e.thread) for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu") and e.id in ids}
    return reduce_by_span(device, launches, ranges)


class MetricsLogger:
    """Append-only JSONL metrics log; mirrors to wandb when available."""

    def __init__(self, log_path: Path, use_wandb: bool = False, config: Optional[Dict] = None):
        self.path = Path(log_path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project="tpuslam", config=config or {})
            except ImportError:
                print("metrics: wandb requested but not installed; JSONL only")

    def log(self, record: Dict, step: Optional[int] = None) -> None:
        payload = dict(record)
        if step is not None:
            payload["step"] = step
        payload["ts"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(payload) + "\n")
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def log_image(self, key: str, image, step: Optional[int] = None) -> None:
        """Mirror an image (PIL or path) to wandb; the JSONL records only a
        reference to it."""
        self.log({key: str(image) if not hasattr(image, "size") else "<image>"},
                 step=step)
        if self._wandb is not None:
            self._wandb.log({key: [self._wandb.Image(image)]}, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def device_ms(fn: Callable[[], object], repeats: int, device: torch.device) -> float:
    """ms per call of `fn()` over `repeats` calls back to back: between two
    CUDA events, after a `synchronize`, on the card; by the host clock on
    the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats * 1e3


def _intrinsics(height: int, width: int) -> np.ndarray:
    return np.array([[0.58 * width, 0, 0.5 * width, 0], [0, 1.92 * height, 0.5 * height, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def random_training_batch(height: int, width: int, batch_size: int, seed: int, device):
    """A training batch of random images (online frame + replay), as the
    JAX package's profilers make theirs."""
    rng = np.random.default_rng(seed)

    def batch(n):
        return make_frame_batch(rng.uniform(size=(n, 3, height, width, 3)).astype(np.float32),
                                _intrinsics(height, width),
                                rng.uniform(0.5, 2.0, size=(n, 2)).astype(np.float32),
                                device=device)

    return concat_batches(batch(1), batch(batch_size - 1)) if batch_size > 1 else batch(1)


def adapt_state(seed: int, device) -> TrainState:
    """Fresh networks drawn from `seed` with the adapt optimizer (decoders
    only), as `Slam` builds them."""
    model = init_depth_pose(seed, device=device)
    model.requires_grad_(False)
    model.depth_decoder.requires_grad_(True)
    model.pose_decoder.requires_grad_(True)
    return make_train_state(model, make_adapt_optimizer(model, 1e-4))


def profile_host_pipeline(
    dataset=None,
    height: int = 192,
    width: int = 640,
    samples: int = 20,
    device="cuda",
) -> Dict[str, float]:
    """Host-side decode / batch micro-benchmark (the feed of the SLAM loop).

    Per frame: `dataset[i]` latency (image decode or synthetic render and
    resize pyramid), the FrameBatch assembly on the host (uint8 images,
    intrinsics, weights as CPU tensors), and the host-to-device copy of
    those tensors, with one `synchronize` at the end (amortised throughput,
    not a per-copy latency).  Compare with the device frame time
    (`profile_adapt_step`) to size `Slam.run`'s prefetch.

    Returns {"ms_decode", "ms_batch", "ms_total_host", "ms_transfer"};
    ms_total_host = decode + assembly (host work only).
    """
    device = resolve_device(device)
    if dataset is None:
        dataset = SyntheticDataset(num_frames=samples + 2, height=height, width=width)
    n = min(samples, len(dataset))
    if n == 0:
        raise ValueError("profile_host_pipeline needs a non-empty dataset")

    t0 = time.perf_counter()
    items = [dataset[i] for i in range(n)]
    ms_decode = (time.perf_counter() - t0) / n * 1e3

    t0 = time.perf_counter()
    batches = [make_frame_batch(s.rgb[None], s.K, s.rel_dist[None], device="cpu") for s in items]
    ms_batch = (time.perf_counter() - t0) / n * 1e3

    t0 = time.perf_counter()
    for b in batches:
        for t in (b.rgb, b.rgb_aug, b.K, b.inv_K, b.rel_dist, b.weights):
            t.to(device, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms_transfer = (time.perf_counter() - t0) / n * 1e3

    return {
        "ms_decode": round(ms_decode, 3),
        "ms_batch": round(ms_batch, 3),
        "ms_total_host": round(ms_decode + ms_batch, 3),
        "ms_transfer": round(ms_transfer, 3),
    }


def profile_sync_latency(
    height: int = 96,
    width: int = 320,
    batch_size: int = 3,
    num_steps: int = 2,
    frames: int = 8,
    seed: int = 0,
    device="cuda",
) -> Dict[str, float]:
    """The per-frame cost of the host readback of the SLAM loop.

    `Slam.step` reads back what the host needs every frame (the packed
    pose, embedding and losses).  The same `adapt_step` runs `frames` times
    back to back with one readback at the end (chained), then with the
    packed readback after every frame (per frame); their difference is the
    cost of the synchronising copy.

    Returns per-frame ms of both, their difference and the two rates.
    """
    device = resolve_device(device)
    training = random_training_batch(height, width, batch_size, seed, device)
    cfg = LossConfig()
    state = adapt_state(seed, device)

    def frame():
        return adapt_step(state, cfg, training, num_steps=num_steps)

    for _ in range(2):  # cuDNN autotuning, warm-up
        _, outputs = frame()
    outputs[("retire_packed",)].cpu()

    t0 = time.perf_counter()
    for _ in range(frames):
        _, outputs = frame()
    outputs[("retire_packed",)].cpu()
    ms_chained = (time.perf_counter() - t0) / frames * 1e3

    t0 = time.perf_counter()
    for _ in range(frames):
        _, outputs = frame()
        outputs[("retire_packed",)].cpu()
    ms_synced = (time.perf_counter() - t0) / frames * 1e3

    return {
        "ms_chained": round(ms_chained, 2),
        "ms_per_frame_sync": round(ms_synced, 2),
        "ms_sync_rtt": round(ms_synced - ms_chained, 2),
        "fps_chained": round(1e3 / ms_chained, 2),
        "fps_synced": round(1e3 / ms_synced, 2),
    }


def profile_adapt_step(
    height: int = 192,
    width: int = 640,
    batch_size: int = 3,
    iters=(1, 5, 10),
    repeats: int = 8,
    use_pallas_warp: bool = True,
    seed: int = 0,
    loss_overrides: Optional[Dict[str, object]] = None,
    device="cuda",
) -> Dict[str, float]:
    """Fixed-cost / per-iteration split of `adapt_step` by a K-sweep.

    Runs `adapt_step` `repeats` times at each K in `iters` (a fresh state
    per K, two warm-up calls) and fits ms_fixed + K * ms_per_iter.  The
    fixed part is the frozen encoders, the embeddings and the packed
    readback's launches; the slope is decoders forward and backward, warp,
    loss and Adam.  `loss_overrides` sets other `LossConfig` fields (the
    `pallas_*` routes).

    Returns {"ms_fixed", "ms_per_iter", "ms_frame_K5", "fps_K5", "ms_K{k}"}.
    """
    device = resolve_device(device)
    training = random_training_batch(height, width, batch_size, seed, device)
    cfg = LossConfig(use_pallas_warp=use_pallas_warp, **(loss_overrides or {}))

    times = {}
    for k in iters:
        state = adapt_state(seed, device)
        for _ in range(2):
            adapt_step(state, cfg, training, num_steps=k)
        times[k] = device_ms(lambda: adapt_step(state, cfg, training, num_steps=k), repeats,
                             device)

    ks = np.array(list(times.keys()), np.float64)
    ts = np.array(list(times.values()), np.float64)
    slope, intercept = np.polyfit(ks, ts, 1)
    frame5 = intercept + 5 * slope
    return {
        "ms_fixed": float(intercept),
        "ms_per_iter": float(slope),
        "ms_frame_K5": float(frame5),
        "fps_K5": float(1000.0 / frame5),
        **{f"ms_K{k}": float(v) for k, v in times.items()},
    }
