"""The port's float-to-uint8 rounding (`tpuslam_torch/train/batch.py::to_uint8`,
the compiled routine of `csrc/to_uint8.cpp`) against numpy's expression and
the JAX package's `make_frame_batch(..., quantize=True)`, on the CPU: every
level, every tie and its float32 neighbours, values outside [0, 1], vector
tails, stacks and flipped views, threads at once, the library's build by
the host C++ compiler alone, and `make_frame_batch`'s dtypes and counters."""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from tpuslam.train.batch import make_frame_batch as jax_make_frame_batch
from tpuslam_torch import tracing
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.ops import build
from tpuslam_torch.train import batch as batch_module
from tpuslam_torch.train.batch import make_frame_batch, to_uint8
from tpuslam_torch.train.pretrain import host_batches


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _numpy(x: np.ndarray) -> np.ndarray:
    """The expression `make_frame_batch` evaluated before the routine."""
    with np.errstate(over="ignore"):
        return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def _jax(values: np.ndarray) -> np.ndarray:
    """The JAX package's `make_frame_batch` rounding of flat float32
    `values`, laid out as one (1, 3, 1, W, 3) triplet."""
    n = values.size
    padded = np.zeros(9 * max(1, -(-n // 9)), np.float32)
    padded[:n] = values
    rgb = padded.reshape(1, 3, 1, -1, 3)
    with np.errstate(over="ignore"):
        batch = jax_make_frame_batch(rgb, np.eye(4, dtype=np.float32), np.ones((1, 2)),
                                     quantize=True)
    return np.asarray(batch.rgb).reshape(-1)[:n]


def _levels_and_ties() -> np.ndarray:
    levels = np.arange(256, dtype=np.float32) / np.float32(255)
    ties = ((np.arange(256, dtype=np.float64) + 0.5) / 255).astype(np.float32)
    up = np.nextafter(ties, np.float32(np.inf))
    down = np.nextafter(ties, np.float32(-np.inf))
    return np.concatenate([levels, ties, up, down])


def _outside() -> np.ndarray:
    return np.array([-np.inf, -3e38, -1.0, -0.5 / 255, -1e-30, -0.0, 0.0, 1e-30, 1.0,
                     np.nextafter(np.float32(1), np.float32(2)), 255.5 / 255, 1.5, 2.0,
                     1e6, 3e38, np.inf], np.float32)


def _random(rng, shape) -> np.ndarray:
    """Values around [0, 1] and past it, with exact levels and ties mixed in."""
    x = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    exact = rng.integers(0, 512, shape) / np.float32(510)
    pick = rng.random(shape) < 0.3
    x[pick] = exact[pick].astype(np.float32)
    return x


CASES = {
    "levels and ties": _levels_and_ties,
    "outside [0, 1] and inf": _outside,
}


@pytest.mark.parametrize("name", list(CASES))
def test_routine_matches_numpy_and_jax(name):
    """The 256 levels k/255, every tie (k + 0.5)/255 with its float32
    neighbours, values below 0 and above 1, and +-inf: numpy's bytes and
    the JAX package's."""
    x = CASES[name]()
    got = to_uint8(x)
    assert got.dtype == np.uint8 and got.shape == x.shape
    np.testing.assert_array_equal(got, _numpy(x))
    np.testing.assert_array_equal(got, _jax(x))


def test_ties_round_half_to_even():
    """x * 255 exactly k + 0.5 rounds to the even neighbour."""
    halves = (np.arange(255, dtype=np.float32) + np.float32(0.5))
    x = halves / np.float32(255)
    exact = x * np.float32(255) == halves
    assert exact.sum() > 50
    got = to_uint8(x[exact]).astype(np.int64)
    want = np.floor(halves[exact]).astype(np.int64)
    want += want % 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 7, 31, 33])
def test_vector_tails(n):
    """Lengths that no vector width divides, each value checked."""
    x = _random(np.random.default_rng(n), (n,))
    got = to_uint8(x)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, _numpy(x))
    if n:
        np.testing.assert_array_equal(got, _jax(x))


def test_stack_and_flipped_view():
    """A (2, 3, 48, 64, 3) stack, and a flipped, non-contiguous view of it:
    the bytes of numpy and of the JAX package's batch; the input untouched."""
    x = _random(np.random.default_rng(11), (2, 3, 48, 64, 3))
    before = x.copy()
    views = {"stack": x, "flipped": x[:, :, :, ::-1]}
    assert not views["flipped"].flags.c_contiguous
    for name, img in views.items():
        got = to_uint8(img)
        assert got.shape == img.shape and got.flags.c_contiguous, name
        np.testing.assert_array_equal(got, _numpy(img), err_msg=name)
        want = jax_make_frame_batch(img, np.eye(4, dtype=np.float32), np.ones((2, 2)),
                                    quantize=True)
        np.testing.assert_array_equal(got, np.asarray(want.rgb), err_msg=name)
    np.testing.assert_array_equal(x, before)


def test_threads_round_as_one():
    """Two threads rounding different images at once (the library runs
    without Python's lock), with a short switch interval, get the bytes
    one thread gets."""
    rng = np.random.default_rng(12)
    images = [_random(rng, (3, 192, 640, 3)) for _ in range(2)]
    want = [_numpy(img) for img in images]
    got = [None, None]
    start = threading.Barrier(2)

    def run(k):
        start.wait()
        got[k] = [to_uint8(images[k]) for _ in range(8)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k in range(2):
        assert len(got[k]) == 8
        for out in got[k]:
            np.testing.assert_array_equal(out, want[k])


def test_library_builds_with_the_host_compiler(tmp_path, monkeypatch):
    """`ops/build.py` builds and loads the rounding's library with `c++` at
    -O3 -ffp-contract=off, without nvcc, which CPU-only machines lack."""
    def no_nvcc():
        raise AssertionError("nvcc was asked for")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_seconds", {})
    command = build._command("to_uint8", tmp_path / "lib.so")
    assert Path(command[0]).name == "c++"
    assert "-O3" in command and "-ffp-contract=off" in command
    assert not any("fast-math" in arg for arg in command)
    lib = build.load_library("to_uint8")
    assert build._library_path("to_uint8").parent == tmp_path
    assert build._library_path("to_uint8").exists()
    assert build.build_seconds["to_uint8"] > 0
    assert lib.tpuslam_to_uint8 is not None
    assert build.load_library("to_uint8") is lib


def _batch_inputs(dtype, B=2, H=8, W=16):
    rng = np.random.default_rng(13)
    if dtype == np.uint8:
        return (rng.integers(0, 256, (B, 3, H, W, 3)).astype(np.uint8),
                rng.integers(0, 256, (B, 3, H, W, 3)).astype(np.uint8))
    return (_random(rng, (B, 3, H, W, 3)).astype(dtype),
            _random(rng, (B, 3, H, W, 3)).astype(dtype))


def _shipped_bytes(batch) -> int:
    shipped = [batch.rgb, batch.K, batch.inv_K, batch.rel_dist, batch.weights]
    if batch.rgb_aug is not batch.rgb:
        shipped.append(batch.rgb_aug)
    return sum(t.numel() * t.element_size() for t in shipped)


def test_float32_batch_takes_the_routine(monkeypatch):
    """float32 images go through the compiled pass, never numpy's
    expression: `to_uint8_values` counts 2 x B x 3 x H x W x 3 with the
    tracer on and nothing off; `h2d_bytes` is the bytes shipped."""
    rgb, aug = _batch_inputs(np.float32)
    want_rgb, want_aug = _numpy(rgb), _numpy(aug)

    def no_numpy(*args, **kwargs):
        raise AssertionError("numpy's rounding was evaluated")

    monkeypatch.setattr(batch_module.np, "rint", no_numpy)
    off = make_frame_batch(rgb, np.eye(4), np.ones((2, 2)), rgb_aug=aug, device="cpu")
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    tracing.enable()
    on = make_frame_batch(rgb, np.eye(4), np.ones((2, 2)), rgb_aug=aug, device="cpu")
    monkeypatch.undo()
    for batch in (off, on):
        np.testing.assert_array_equal(batch.rgb.numpy(), want_rgb)
        np.testing.assert_array_equal(batch.rgb_aug.numpy(), want_aug)
    snap = tracing.snapshot()
    assert snap["counters"] == {"h2d_bytes": _shipped_bytes(on),
                                "to_uint8_values": 2 * rgb.size}
    assert snap["spans"]["data.to_uint8"]["count"] == 2


def test_pretraining_batches_take_the_routine():
    """The pretraining route (`host_batches` of an augmenting loader, then
    `make_frame_batch`) rounds both image stacks in the compiled pass."""
    ds = SyntheticDataset(num_frames=6, height=32, width=64, do_augmentation=True)
    arrays = next(host_batches(ds, 2, np.random.default_rng(14)))
    assert arrays["rgb"].dtype == arrays["rgb_aug"].dtype == np.float32
    tracing.enable()
    batch = make_frame_batch(**arrays, device="cpu")
    assert tracing.snapshot()["counters"]["to_uint8_values"] == 2 * 2 * 3 * 32 * 64 * 3
    np.testing.assert_array_equal(batch.rgb.numpy(), _numpy(arrays["rgb"]))
    np.testing.assert_array_equal(batch.rgb_aug.numpy(), _numpy(arrays["rgb_aug"]))


def test_uint8_batch_passes_through():
    """uint8 images ship as they are, rounded by nobody."""
    rgb, aug = _batch_inputs(np.uint8)
    tracing.enable()
    batch = make_frame_batch(rgb, np.eye(4), np.ones((2, 2)), rgb_aug=aug, device="cpu")
    np.testing.assert_array_equal(batch.rgb.numpy(), rgb)
    np.testing.assert_array_equal(batch.rgb_aug.numpy(), aug)
    assert np.shares_memory(batch.rgb.numpy(), rgb)
    snap = tracing.snapshot()
    assert snap["counters"] == {"h2d_bytes": _shipped_bytes(batch)}
    assert "data.to_uint8" not in snap["spans"]


@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_other_float_dtypes_keep_numpy(dtype):
    """float64 and float16 images keep numpy's expression, whose product
    rounds in their own precision: the bytes of numpy and of the JAX
    package, nothing counted by the compiled pass."""
    rgb, aug = _batch_inputs(dtype)
    tracing.enable()
    batch = make_frame_batch(rgb, np.eye(4), np.ones((2, 2)), rgb_aug=aug, device="cpu")
    want = jax_make_frame_batch(rgb, np.eye(4, dtype=np.float32), np.ones((2, 2)),
                                rgb_aug=aug, quantize=True)
    for got, x, ref in ((batch.rgb, rgb, want.rgb), (batch.rgb_aug, aug, want.rgb_aug)):
        np.testing.assert_array_equal(got.numpy(), _numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    snap = tracing.snapshot()
    assert snap["counters"] == {"h2d_bytes": _shipped_bytes(batch)}
    assert snap["spans"]["data.to_uint8"]["count"] == 2


def test_without_aug_the_batch_aliases_rgb():
    """`rgb_aug=None` reuses the shipped `rgb`: one rounding, one copy."""
    rgb, _ = _batch_inputs(np.float32)
    tracing.enable()
    batch = make_frame_batch(rgb, np.eye(4), np.ones((2, 2)), device="cpu")
    assert batch.rgb_aug is batch.rgb
    snap = tracing.snapshot()
    assert snap["counters"] == {"h2d_bytes": _shipped_bytes(batch),
                                "to_uint8_values": rgb.size}
