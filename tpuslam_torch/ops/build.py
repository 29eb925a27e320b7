"""Build and load the port's native libraries: the CUDA kernels and the
host's colour jitter and uint8 rounding.

Each source in `csrc/` is compiled into a shared library with a plain C
interface, under `build/`, named by the hash of the source and its flags, at
first use; it is then loaded with ctypes.  A `.cu` source is built by nvcc
for `sm_90a`, a `.cpp` source by the host C++ compiler (`c++`), so the host
library builds where there is no CUDA toolkit.  No PyTorch header is
included, so a build takes seconds.  `build_kernels()` starts one compiler
for every source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# library name -> (source file in csrc/, extra compiler flags)
SOURCES = {
    "warp": ("warp.cu", ()),
    # the SSIM moments cancel (E[x^2] - mu^2): without FMA contraction the
    # kernels round like the plain torch version, op by op
    "reproj": ("reproj.cu", ("-fmad=false",)),
    # rounds like the numpy colour jitter, op by op
    "jitter": ("jitter.cpp", ("-ffp-contract=off",)),
    # rounds like numpy's float32 expression
    "to_uint8": ("to_uint8.cpp", ("-ffp-contract=off",)),
}

# seconds the compiler took for each library built by this process
build_seconds: Dict[str, float] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def nvcc_command(source: Path, out: Path, flags: Iterable[str] = ()) -> list:
    """The nvcc command line that builds `source` into the shared library
    `out` for sm_90a."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            *flags, "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(source)]


def _host_command(source: Path, out: Path, flags: Iterable[str] = ()) -> list:
    """The host C++ compiler's command line that builds `source` into the
    shared library `out`."""
    found = shutil.which("c++")
    if not found:
        raise RuntimeError("c++ not found: the host libraries are built from source at first use")
    return [found, "-std=c++17", "-O3", *flags, "-shared", "-fPIC", "-o", str(out), str(source)]


def _command(name: str, out: Path) -> list:
    source, flags = SOURCES[name]
    build = nvcc_command if source.endswith(".cu") else _host_command
    return build(CSRC / source, out, flags)


def _library_path(name: str) -> Path:
    source, flags = SOURCES[name]
    digest = hashlib.sha256((CSRC / source).read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"libtpuslam_{name}_{digest.hexdigest()[:16]}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> None:
    """Compile the libraries that are not built yet, all compilers at once;
    raise with the compiler's output if any fails."""
    jobs = []
    for name in (SOURCES if names is None else names):
        so = _library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, proc, t0 in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{Path(proc.args[0]).name} failed on {SOURCES[name][0]} "
                          f"({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed; threads that ask
    at once wait for one build."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build_kernels([name])
            lib = _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return lib
