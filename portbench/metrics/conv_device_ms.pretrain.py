"""Device milliseconds per training step in convolution kernels (cuDNN's
direct, implicit-GEMM, Winograd and FFT convolutions, forward and both
backward passes, and the FFT transforms and complex GEMMs of the FFT
route), from the profiled slice, by the kernel-name patterns below."""

PATTERNS = ("conv", "fprop", "dgrad", "wgrad", "fft", "cgemm", "winograd", "implicit",
            "xmma", "cudnn")


def read(run):
    s = run.get("slice")
    if run["kind"] != "pretrain" or not s or not s["units"]:
        return None
    total = sum(t for name, t in s["by_name"].items()
                if any(p in name.lower() for p in PATTERNS))
    return 1e3 * total / s["units"] if total > 0 else None
