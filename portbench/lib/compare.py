"""The numbers that decide `correct`, each a gap between the program and the
reference, and their report."""
from __future__ import annotations

import math
import sys
from typing import Dict, Iterable

import numpy as np


def rel_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> float:
    """The largest gap between the two sides' norms of a leaf, against the
    reference's norm of that leaf or of the median leaf, whichever is larger."""
    keep = [k for k in keep if k in ref]
    if not keep:
        return float("nan")
    median = float(np.median([ref[k] for k in keep]))
    # a leaf the program gives no number for reads nan, and fails
    return max(abs(prog.get(k, float("nan")) - ref[k]) / max(ref[k], median, 1e-30)
               for k in keep)


def median_leaf(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> float:
    """The median over leaves of the gap `worst_leaf` takes the largest of."""
    keep = [k for k in keep if k in ref]
    if not keep:
        return float("nan")
    median = float(np.median([ref[k] for k in keep]))
    return float(np.median([abs(prog.get(k, float("nan")) - ref[k]) / max(ref[k], median, 1e-30)
                            for k in keep]))


def pose_gap(got: np.ndarray, want: np.ndarray) -> float:
    """|got - want| over the 3x4 part, against how far `want` moves from the
    identity (at least 1e-3)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    motion = max(np.linalg.norm(want[:3] - np.eye(4)[:3]), 1e-3)
    return float(np.linalg.norm(got[:3] - want[:3]) / motion)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: [value, limit]}); a number that is missing or not
    finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = float(numbers.get(name, float("nan")))
        out[name] = [value, limit]
        if not math.isfinite(value) or value > limit:
            ok = False
    return ok, out


def print_checks(checks: Dict[str, list]) -> None:
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
