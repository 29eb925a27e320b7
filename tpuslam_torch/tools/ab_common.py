"""What the kernel A/B tools (`reproj_ab`, `warp_ab`) share: building a
kernel source like `ops/build.py` does with `-Xptxas -v`, the card's name and
power limit, and the device time of one launch with the L2 flushed."""
from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

from tpuslam_torch.ops import build


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def demangle(filt: Path, names: List[str]) -> List[str]:
    """Each kernel's name and template arguments, `warp_kernel<float,
    (bool)1, (bool)0, (bool)0, (int)3>`, from its mangled name by `filt`
    (cu++filt)."""
    out = subprocess.run([str(filt), *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return [m.group(1) if (m := re.search(r"(\w+<.*?>)\(", d)) else d for d in out]


def compile_source(name: str, source: Path, out_dir: Path, declare: Callable,
                   label: Optional[Callable[[str], str]] = None
                   ) -> Tuple[ctypes.CDLL, List[str]]:
    """Build `source` with the flags of library `name` in `ops/build.py` and
    -Xptxas -v; return the library loaded and declared by `declare`, and one
    line per kernel: registers, shared memory, spills, under the kernel's
    name by `label`, or by cu++filt (which ships beside nvcc)."""
    digest = hashlib.sha256(str(source.resolve()).encode()).hexdigest()[:16]
    so = out_dir / f"lib_{source.stem}_{digest}.so"
    _, flags = build.SOURCES[name]
    command = build.nvcc_command(source, so, [*flags, "-Xptxas", "-v"])
    proc = subprocess.run(command, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    kernels, usage, kernel, spill = [], [], "?", ""
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"'(_Z\w+)'", line)
            kernel = m.group(1) if m else line.strip()
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "registers" in line:
            kernels.append(kernel)
            usage.append(f"{line.split(':', 1)[1].strip()}; {spill}")
    names = ([label(k) for k in kernels] if label else
             demangle(Path(command[0]).with_name("cu++filt"), kernels))
    return declare(ctypes.CDLL(str(so))), [f"{k}: {u}" for k, u in zip(names, usage)]


def cold_ms(fn, flush: torch.Tensor, iters: int = 20, warm: int = 5) -> float:
    """Mean device time of one call of `fn` from CUDA events around it, with
    `flush` (larger than the 50 MB L2) written before each call."""
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(warm + iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events[warm:]) / iters


def flush_buffer(device) -> torch.Tensor:
    """256 MB to write between timed launches: five times the H100's L2."""
    return torch.empty(2 ** 26, dtype=torch.float32, device=device)
