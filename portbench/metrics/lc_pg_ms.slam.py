"""Host milliseconds per frame in loop-closure index inserts and searches and
in pose-graph solves, over the window."""


def read(run):
    spans = run.get("spans")
    if run["kind"] != "slam" or not spans or not run["units"]:
        return None
    total = sum(v for k, v in spans["total"].items() if k.startswith(("lc.", "pg.")))
    return 1e3 * total / run["units"]
