"""The 90th percentile over the window's frames of a frame's latency: from
its hand-over to `Slam.step` to the return of the public call that retires
it (`step(t + pipeline_depth)`, or the closing flush).  A per-layer metric:
its runs spread too widely between processes to carry a bound (PERF.md)."""


def read(run):
    if run["kind"] != "slam" or not run["units"]:
        return None
    return run["frame_ms_p90"]
