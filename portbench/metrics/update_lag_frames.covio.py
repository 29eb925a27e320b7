"""The median, over the updates adopted in the window, of the frames served
between an update's launch and its adoption, from the harness's wraps of
`consolidate_step_async` and `Slam._adopt`."""


def read(run):
    if run["kind"] != "slam" or run.get("update_lag_frames") is None or not run.get("spans"):
        return None
    return run["update_lag_frames"]
