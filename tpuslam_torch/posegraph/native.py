"""ctypes binding of the C++ pose-graph solver `native/posegraph.cc`.

LM over SE(3) in double, with a banded Cholesky for the odometry chain and
Woodbury corrections for loop edges; the counterpart of the reference's g2o
solve for pose-only graphs.  The shared library is built with g++ from the
repository's source at first use, into `build/`, named by the hash of the
source and the flags (the flags of `tpuslam/posegraph/native.py`, so both
packages run the same machine code on the same arrays).  `native/` is only
read.  `is_available()` tells whether the build succeeded; the solver
functions raise with g++'s output when it did not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tpuslam_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "posegraph.cc"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtpuslam_posegraph_{digest}.so"


def _build(so: Path) -> Optional[str]:
    """Compile the library into `so`; g++'s output on failure, else None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:  # no g++ on this machine
        return str(e)
    if proc.returncode != 0:
        return f"g++ failed on {SOURCE} ({proc.returncode}):\n{proc.stderr}"
    os.replace(tmp, so)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    if not SOURCE.exists():
        _build_error = f"missing source {SOURCE}"
        return None
    so = library_path()
    if not so.exists():
        _build_error = _build(so)
        if _build_error is not None:
            return None
    lib = ctypes.CDLL(str(so))
    lib.pose_graph_optimize.restype = ctypes.c_int
    lib.pose_graph_optimize.argtypes = [
        ctypes.c_int, _f64p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, _i32p,
        _f64p, _f64p, ctypes.c_int, _f64p,
    ]
    lib.pose_graph_error.restype = ctypes.c_double
    lib.pose_graph_error.argtypes = [ctypes.c_int, _f64p, ctypes.c_int, _i32p, _f64p, _f64p]
    _lib = lib
    return _lib


def is_available() -> bool:
    """True when the library is built (building it at the first call)."""
    return _load() is not None


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises with g++'s output
    when the build failed."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native pose-graph solver unavailable: {_build_error}")
    return lib


def _edge_arrays(poses, edges_ij, measurements, information):
    """Contiguous arrays of the C layout, checked against each other."""
    poses = np.ascontiguousarray(poses, np.float64).reshape(-1, 4, 4).copy()
    edges_ij = np.ascontiguousarray(edges_ij, np.int32).reshape(-1, 2)
    measurements = np.ascontiguousarray(measurements, np.float64).reshape(-1, 4, 4)
    information = np.ascontiguousarray(information, np.float64).reshape(-1, 6, 6)
    if not len(edges_ij) == len(measurements) == len(information):
        raise ValueError("edges, measurements and information differ in length")
    if len(edges_ij) and (edges_ij.min() < 0 or edges_ij.max() >= len(poses)):
        raise ValueError("an edge references a vertex index out of range")
    return poses, edges_ij, measurements, information


def optimize_native(
    poses: np.ndarray,
    fixed: np.ndarray,
    edges_ij: np.ndarray,
    measurements: np.ndarray,
    information: np.ndarray,
    max_iterations: int = 25,
) -> Tuple[np.ndarray, float]:
    """Run the C++ LM solver.  Arrays: poses (N, 4, 4), fixed (N,), edges
    (M, 2), measurements (M, 4, 4), information (M, 6, 6).  Returns
    (optimised poses, final error)."""
    lib = library()
    poses, edges_ij, measurements, information = _edge_arrays(
        poses, edges_ij, measurements, information)
    fixed = np.ascontiguousarray(fixed, np.uint8).reshape(-1)
    if len(fixed) != len(poses):
        raise ValueError("fixed and poses differ in length")
    err = ctypes.c_double(0.0)
    rc = lib.pose_graph_optimize(
        len(poses), poses.ctypes.data_as(_f64p),
        fixed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(edges_ij),
        edges_ij.ctypes.data_as(_i32p), measurements.ctypes.data_as(_f64p),
        information.ctypes.data_as(_f64p), int(max_iterations), ctypes.byref(err),
    )
    if rc != 0:
        raise RuntimeError(f"native pose_graph_optimize failed with code {rc}")
    return poses, float(err.value)


def graph_error_native(
    poses: np.ndarray,
    edges_ij: np.ndarray,
    measurements: np.ndarray,
    information: np.ndarray,
) -> float:
    """Total weighted squared error of a pose-only graph, in C++."""
    lib = library()
    poses, edges_ij, measurements, information = _edge_arrays(
        poses, edges_ij, measurements, information)
    return float(lib.pose_graph_error(
        len(poses), poses.ctypes.data_as(_f64p), len(edges_ij),
        edges_ij.ctypes.data_as(_i32p), measurements.ctypes.data_as(_f64p),
        information.ctypes.data_as(_f64p)))
