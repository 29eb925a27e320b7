"""CoVIO's whole loop's share of the chip's peak, over the window's wall
time and the peak of the precision the configuration states (989 TFLOP/s
for bf16): the network operations counted as `mfu.slam` counts them
(`portbench/lib/flops.py`).  Each frame served: the frozen encoders at batch
1, the loop-closure embedding and the decoders' forward once.  Each update
adopted in the window: the frozen encoders at the configuration's batch and
K forward and backward passes of the decoders.  Work the program recomputes
is not counted."""


def loop_flops(settings: dict, frames: int, updates: int) -> float:
    from portbench.lib.flops import slam_parts

    pc, sl = settings["DepthPosePrediction"], settings["Slam"]
    served = slam_parts(settings, 1)
    update = slam_parts(settings, pc["batch_size"])
    return float(frames * (served["encoders"] + served["embed"] + served["decode"])
                 + updates * (update["encoders"]
                              + sl["adaptation_epochs"] * update["decode_train"]))


def read(run):
    if run["kind"] != "slam" or not run["units"] or "updates" not in run or not run.get("spans"):
        return None
    from portbench.lib.peaks import FLOPS

    peak = FLOPS[run["spec"]["precision"]]
    flops = loop_flops(run["settings"], run["units"], run["updates"])
    return 100.0 * flops / run["window_s"] / peak
