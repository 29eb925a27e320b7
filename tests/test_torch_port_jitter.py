"""The port's colour jitter (`tpuslam_torch/data/base.py::random_color_jitter`,
the compiled routine of `csrc/jitter.cpp`) against the JAX package's numpy
jitter, on the CPU: every order of the four ops on 8-bit, flat grey, black,
saturated and flipped images, the generator's draws, the output's layout, the
tracer's counter, threads at once, and the library's build by the host
C++ compiler alone."""
import itertools
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from tpuslam.data.base import random_color_jitter as jax_random_color_jitter
from tpuslam_torch import tracing
from tpuslam_torch.data.base import random_color_jitter
from tpuslam_torch.ops import build

# 12,288 pixels: the contrast's mean sums two of numpy's 8,192-value chunks
H, W = 96, 128
ORDERS = list(itertools.permutations(range(4)))


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _seed_for(order) -> int:
    """The first generator seed whose jitter runs its ops in `order`: the
    jitter draws four factors, then the order."""
    for seed in itertools.count():
        rng = np.random.default_rng(seed)
        rng.uniform(0.8, 1.2, size=3)
        rng.uniform(-0.1, 0.1)
        if tuple(rng.permutation(4)) == order:
            return seed


def _images(rng) -> dict:
    palette = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
                        [1, 1, 1], [0.6, 0.6, 0.2], [0.2, 0.6, 0.6], [0.6, 0.2, 0.6],
                        [0.3, 0.3, 0.3], [0.9, 0.4, 0.4], [0.4, 0.9, 0.4], [0.4, 0.4, 0.9]],
                       np.float32)
    eight_bit = lambda: (rng.integers(0, 256, (H, W, 3)) / 255).astype(np.float32)  # noqa: E731
    return {
        "8-bit": eight_bit(),
        "flat grey": np.full((H, W, 3), 0.5, np.float32),
        "black": np.zeros((H, W, 3), np.float32),
        "primaries and ties": palette[rng.integers(0, len(palette), (H, W))],
        "flipped view": eight_bit()[:, ::-1],
    }


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """`make_frame_batch`'s rounding of float frames."""
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("order", ORDERS, ids=["".join(map(str, o)) for o in ORDERS])
def test_jitter_matches_jax_package(order):
    """Each order of brightness (0), contrast (1), saturation (2) and hue (3):
    within 4e-6 of the JAX package's numpy jitter, no byte more than one
    level off after the uint8 rounding and at most 1e-4 of them off at all;
    the generator left where the JAX package leaves it; a new C-contiguous
    float32 image, the input untouched."""
    seed = _seed_for(order)
    port_rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    port, want = random_color_jitter(port_rng), jax_random_color_jitter(jax_rng)
    assert port_rng.bit_generator.state == jax_rng.bit_generator.state
    assert port_rng.random() == jax_rng.random()
    for name, img in _images(np.random.default_rng(seed + 1)).items():
        before = img.copy()
        got, ref = port(img), want(img)
        np.testing.assert_array_equal(img, before, err_msg=name)
        assert got.dtype == np.float32 and got.flags.c_contiguous and got.shape == img.shape
        assert not np.shares_memory(got, img), name
        gap = float(np.abs(got - ref.astype(np.float64)).max())
        assert gap <= 4e-6, (name, gap)
        levels = np.abs(_to_uint8(got).astype(np.int16) - _to_uint8(ref))
        assert levels.max() <= 1, name
        assert np.count_nonzero(levels) <= 1e-4 * levels.size, (name, np.count_nonzero(levels))


def test_jitter_takes_uint8_scaled_float64():
    """An 8-bit image scaled in float64 jitters as its float32 cast."""
    u8 = np.random.default_rng(3).integers(0, 256, (H, W, 3))
    jitter = random_color_jitter(np.random.default_rng(4))
    np.testing.assert_array_equal(jitter(u8 / 255.0), jitter((u8 / 255.0).astype(np.float32)))


def test_jitter_rejects_other_shapes():
    jitter = random_color_jitter(np.random.default_rng(5))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        jitter(np.zeros((2, H, W, 3), np.float32))


def test_jitter_counts_images():
    """`jitter_images` counts each image jittered, with the tracer on only."""
    jitter = random_color_jitter(np.random.default_rng(6))
    img = np.random.default_rng(7).random((H, W, 3), dtype=np.float32)
    jitter(img)
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    tracing.enable()
    for _ in range(3):
        jitter(img)
    snap = tracing.snapshot()
    assert snap["counters"] == {"jitter_images": 3}
    assert snap["spans"]["data.jitter"]["count"] == 3


def test_threads_jitter_as_one():
    """More threads than cores jittering different images at once (the
    library runs without Python's lock, as on the `Prefetcher`'s thread),
    with a short switch interval, get the bytes one thread gets."""
    rng = np.random.default_rng(8)
    n = (os.cpu_count() or 1) + 2
    work = [(random_color_jitter(np.random.default_rng(s)), rng.random((192, 640, 3), np.float32))
            for s in range(9, 9 + n)]
    want = [jitter(img) for jitter, img in work]
    got = [None] * n
    start = threading.Barrier(n)

    def run(k):
        jitter, img = work[k]
        start.wait()
        got[k] = [jitter(img) for _ in range(4)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k in range(n):
        assert len(got[k]) == 4
        for out in got[k]:
            np.testing.assert_array_equal(out, want[k])


def test_first_loads_from_threads_build_once(tmp_path, monkeypatch):
    """Threads that load the library at once wait for one build."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    builds = []
    build_kernels = build.build_kernels
    monkeypatch.setattr(build, "build_kernels", lambda names: builds.append(names) or
                        build_kernels(names))
    libs = [None] * 8
    start = threading.Barrier(8)

    def load(k):
        start.wait()
        libs[k] = build.load_library("jitter")

    threads = [threading.Thread(target=load, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["jitter"]]
    assert all(lib is libs[0] for lib in libs) and libs[0] is not None


def test_jitter_library_builds_with_the_host_compiler(tmp_path, monkeypatch):
    """`ops/build.py` builds and loads the jitter library with `c++` at
    -O3 -ffp-contract=off, without nvcc, which CPU-only machines lack."""
    def no_nvcc():
        raise AssertionError("nvcc was asked for")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_seconds", {})
    command = build._command("jitter", tmp_path / "lib.so")
    assert Path(command[0]).name == "c++"
    assert "-O3" in command and "-ffp-contract=off" in command
    assert not any("fast-math" in arg for arg in command)
    lib = build.load_library("jitter")
    assert build._library_path("jitter").parent == tmp_path
    assert build._library_path("jitter").exists()
    assert build.build_seconds["jitter"] > 0
    assert lib.tpuslam_color_jitter is not None
    assert build.load_library("jitter") is lib


def test_jitter_build_failure_raises_the_compiler_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "jitter.cpp").write_text('extern "C" void tpuslam_color_jitter() { not_declared; }\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="c\\+\\+ failed on jitter.cpp") as failed:
        build.load_library("jitter")
    assert "not_declared" in str(failed.value)
