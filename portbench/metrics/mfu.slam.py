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
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.lib.weights import encoder_depths
    from portbench.reference.nets import DepthPoseNet

    ds, pc, sl = settings["Dataset"], settings["DepthPosePrediction"], settings["Slam"]
    H, W = ds["height"], ds["width"]
    adapting = sl["adaptation"]
    B = pc["batch_size"] if adapting else 1
    depth, pose = encoder_depths(pc)
    with torch.device("meta"):
        net = DepthPoseNet(tuple(pc["scales"]), depth, resnet_pose=pose)
        images = torch.zeros(B, H, W, 3)
        pairs = torch.zeros(2 * B, H, W, 6)
        online = torch.zeros(1, H, W, 3)
    with FlopCounterMode(display=False) as count:
        with torch.no_grad():
            feats = net.depth_encoder(images)
            pose_feat = net.pose_encoder(pairs)[-1]
            if sl.get("do_loop_closures", True):
                net.depth_encoder(online)
    encoders = count.get_total_flops()
    with FlopCounterMode(display=False) as count:
        disps = net.depth_decoder([f.detach() for f in feats])
        aa, tr = net.pose_decoder(pose_feat.detach())
        if adapting:
            (sum(d.sum() for d in disps.values()) + aa.sum() + tr.sum()).backward()
    decoders = count.get_total_flops()
    return float(encoders + (sl["adaptation_epochs"] if adapting else 1) * decoders)


def read(run):
    if run["kind"] != "slam" or not run["units"] or not run.get("spans"):
        return None
    from portbench.lib.peaks import FLOPS

    peak = FLOPS[run["spec"]["precision"]]
    return 100.0 * frame_flops(run["settings"]) * run["units"] / run["window_s"] / peak
