"""The run's surroundings: where caches and logs go, the card, the clock of
the process, and the check that no JAX module was loaded."""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuslam")


def process_seconds() -> float:
    """Seconds since this process started, from the kernel's start time."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's nvcc and g++ libraries already go to `build/`); JAX kept out
    of any library that would load it by itself."""
    cache = ROOT / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("MPLCONFIGDIR", "matplotlib")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def scratch_dir(cell: str) -> Path:
    """Fixed per-cell folder under the given TMPDIR for what the program
    logs (never a name made from the pid or the time)."""
    base = Path(os.environ.get("TMPDIR") or (Path.home() / ".cache"))
    path = base / "portbench" / cell
    path.mkdir(parents=True, exist_ok=True)
    return path


def require_cards(n: int):
    """Exit without a result unless CUDA shows at least `n` cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"portbench: needs {n} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        sys.exit(3)


def card() -> dict:
    import torch

    if not on_card():
        return {"kind": "cpu (test run)", "count": 0, "power_limit": "none"}
    limit = "unknown"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip() or limit
    except (OSError, subprocess.SubprocessError):
        pass
    return {"kind": torch.cuda.get_device_name(0), "count": 1, "power_limit": limit}


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


# The device the harness drives.  Only the CPU tests set "cpu": they run a
# cell at a tiny size with the program's plain kernels, and no device metric.
DEVICE = "cuda"


def on_card() -> bool:
    return DEVICE == "cuda"


def sync() -> None:
    import torch

    if on_card():
        torch.cuda.synchronize()


def peak_bytes() -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if on_card() else 0


def free() -> None:
    import torch

    if on_card():
        torch.cuda.empty_cache()
