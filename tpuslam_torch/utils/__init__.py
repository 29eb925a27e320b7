"""Tracing, profiling and calibration (`utils/calibration.py`, imported on
its own)."""
from tpuslam_torch.utils.profiling import (
    MetricsLogger,
    profile_adapt_step,
    profile_host_pipeline,
    profile_sync_latency,
    trace,
)

__all__ = [
    "MetricsLogger",
    "profile_adapt_step",
    "profile_host_pipeline",
    "profile_sync_latency",
    "trace",
]
