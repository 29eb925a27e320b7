"""Tracing and profiling hooks.

Counterpart of `tpuslam/utils/profiling.py`:

- `StepTimer`: rolling per-step wall-clock statistics (frames per second is
  the end-to-end metric).
- `trace`: a context manager around `torch.profiler` that writes a Chrome
  trace of the host and, on the card, of the device into `log_dir`.
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

import contextlib
import json
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpuslam_torch import resolve_device
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.train.batch import concat_batches, make_frame_batch
from tpuslam_torch.train.state import TrainState, make_adapt_optimizer, make_train_state
from tpuslam_torch.train.steps import LossConfig, adapt_step


class StepTimer:
    def __init__(self, window: int = 100):
        self.times = deque(maxlen=window)
        self._t0: Optional[float] = None
        self.total_steps = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self.total_steps += 1
        return False

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    @property
    def mean_ms(self) -> float:
        if not self.times:
            return 0.0
        return 1000.0 * sum(self.times) / len(self.times)


@contextlib.contextmanager
def trace(log_dir: Path, enabled: bool = True):
    """Profile the block with `torch.profiler` (host, and the device when
    CUDA is available) and write `log_dir/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto).  Yields the profiler, or None when not
    enabled."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


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
