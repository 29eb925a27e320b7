"""The network operations of the SLAM loop's parts, counted with
FlopCounterMode over the benchmark's own reference networks on meta tensors,
at the configuration's shapes and encoder depths."""
from __future__ import annotations


def slam_parts(settings: dict, batch: int) -> dict:
    """FLOPs at `batch` rows: "encoders", the frozen encoders (depth on the
    rows' frame 0, pose on their 2 * `batch` pairs); "embed", the
    loop-closure embedding (the depth encoder on the online frame +1; 0
    without loop closures); "decode", the decoders' forward; "decode_train",
    their forward and backward."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.lib.weights import encoder_depths
    from portbench.reference.nets import DepthPoseNet

    ds, pc, sl = settings["Dataset"], settings["DepthPosePrediction"], settings["Slam"]
    H, W = ds["height"], ds["width"]
    depth, pose = encoder_depths(pc)
    with torch.device("meta"):
        net = DepthPoseNet(tuple(pc["scales"]), depth, resnet_pose=pose)
        images = torch.zeros(batch, H, W, 3)
        pairs = torch.zeros(2 * batch, H, W, 6)
        online = torch.zeros(1, H, W, 3)
    out = {"embed": 0}
    with torch.no_grad():
        with FlopCounterMode(display=False) as count:
            feats = net.depth_encoder(images)
            pose_feat = net.pose_encoder(pairs)[-1]
        out["encoders"] = count.get_total_flops()
        if sl.get("do_loop_closures", True):
            with FlopCounterMode(display=False) as count:
                net.depth_encoder(online)
            out["embed"] = count.get_total_flops()
    for key, train in (("decode", False), ("decode_train", True)):
        with FlopCounterMode(display=False) as count:
            disps = net.depth_decoder([f.detach() for f in feats])
            aa, tr = net.pose_decoder(pose_feat.detach())
            if train:
                (sum(d.sum() for d in disps.values()) + aa.sum() + tr.sum()).backward()
        out[key] = count.get_total_flops()
    return out
