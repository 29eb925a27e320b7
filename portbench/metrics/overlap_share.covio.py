"""The share of the side stream's busy time in the profiled slice during
which the serving stream is busy too: the union of the side stream's
activities intersected with the union of the serving stream's, over the
former, in percent."""


def read(run):
    s = run.get("slice")
    side = s.get("side") if s else None
    if run["kind"] != "slam" or not side or side["busy_s"] <= 0:
        return None
    return 100.0 * side["overlap_s"] / side["busy_s"]
