"""Host milliseconds per training step that the training thread waits on the
`Prefetcher` for its next batch, over the window."""


def read(run):
    spans = run.get("spans")
    if run["kind"] != "pretrain" or not spans or not run["units"]:
        return None
    return 1e3 * spans["total"].get("data.prefetch_wait", 0.0) / run["units"]
