"""Host milliseconds per frame inside the frame's calls into the fused steps
(`adapt_step`, `eval_step`, `embed`, `predict_pose_step` as `Slam` calls
them), over the window: their launch cost, since the device runs behind."""


def read(run):
    spans = run.get("spans")
    if run["kind"] != "slam" or not spans or not run["units"]:
        return None
    total = sum(v for k, v in spans["total"].items() if k.startswith("steps."))
    return 1e3 * total / run["units"]
