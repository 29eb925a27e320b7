"""Share of the profiled slice of a SLAM cell in which no operation ran on
the device: 1 - (union of the device activity intervals) / (the slice's wall
time), in percent.  The slice runs under torch.profiler, whose host cost
lengthens the wall time a little."""


def read(run):
    s = run.get("slice")
    if run["kind"] != "slam" or not s or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
