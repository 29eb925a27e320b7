"""The whole SLAM frame's share of the chip's peak: the network operations a
frame needs, counted with FlopCounterMode over the benchmark's own reference
networks on meta tensors at the cell's shapes and encoder depths, times the
frames of the window, over the window's wall time and the peak of the
precision the configuration states (989 TFLOP/s for bf16).  Counted once
each: the frozen encoders (depth on the batch's frame 0, pose on its 2B
pairs) and the loop-closure embedding (depth encoder on the online frame
+1); then, when adapting, K times the decoders' forward and backward, else
their forward once.  Work the program recomputes is not counted."""



def frame_flops(settings: dict) -> float:
    from portbench.lib.flops import slam_parts

    pc, sl = settings["DepthPosePrediction"], settings["Slam"]
    if not sl["adaptation"]:
        parts = slam_parts(settings, 1)
        return float(parts["encoders"] + parts["embed"] + parts["decode"])
    parts = slam_parts(settings, pc["batch_size"])
    return float(parts["encoders"] + parts["embed"]
                 + sl["adaptation_epochs"] * parts["decode_train"])


def read(run):
    if run["kind"] != "slam" or not run["units"] or not run.get("spans"):
        return None
    from portbench.lib.peaks import FLOPS

    peak = FLOPS[run["spec"]["precision"]]
    return 100.0 * frame_flops(run["settings"]) * run["units"] / run["window_s"] / peak
