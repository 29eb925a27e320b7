"""Share of the profiled slice of a pretraining cell in which no operation ran
on the device: 1 - (union of the device activity intervals) / (the slice's
wall time), in percent."""


def read(run):
    s = run.get("slice")
    if run["kind"] != "pretrain" or not s or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
