"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at its 700 W limit), copied from the program's
`utils/calibration.py` and `chip_smoke.py`."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "float32": 67e12,  # outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
}
