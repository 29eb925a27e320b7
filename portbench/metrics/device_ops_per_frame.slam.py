"""Device activities (kernels, copies, memsets) per frame in the profiled
slice of a SLAM cell."""


def read(run):
    s = run.get("slice")
    if run["kind"] != "slam" or not s or not s["activities"]:
        return None
    return s["activities"] / s["units"]
