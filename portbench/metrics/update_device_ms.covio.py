"""Device milliseconds per update on `Slam`'s side stream in the profiled
slice: the union of the activities on that stream over the updates launched
in the slice (the slice starts with none in flight and ends in a
synchronize)."""


def read(run):
    s = run.get("slice")
    side = s.get("side") if s else None
    if run["kind"] != "slam" or not side or not side["updates"] or side["busy_s"] <= 0:
        return None
    return 1e3 * side["busy_s"] / side["updates"]
