"""The whole pretraining step's share of the chip's peak: the network
operations of a step (forward and backward through the depth and pose
networks at the configuration's batch and encoder depths, the pose encoder
on 2B pairs), counted with FlopCounterMode over the benchmark's own
reference networks on meta tensors, times the steps of the window, over the
window's wall time and the peak of the configuration's precision (67
TFLOP/s for float32 with TF32 off)."""



def step_flops(settings: dict) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.lib.weights import encoder_depths
    from portbench.reference.nets import DepthPoseNet

    pc = settings["Pretrainer"]
    H, W, B = pc["height"], pc["width"], pc["batch_size"]
    depth, pose = encoder_depths(pc)
    with torch.device("meta"):
        net = DepthPoseNet(tuple(pc["scales"]), depth, resnet_pose=pose).train()
        images = torch.zeros(B, H, W, 3)
        pairs = torch.zeros(2 * B, H, W, 6)
    with FlopCounterMode(display=False) as count:
        disps = net.depth_decoder(net.depth_encoder(images))
        aa, tr = net.pose_decoder(net.pose_encoder(pairs)[-1])
        (sum(d.sum() for d in disps.values()) + aa.sum() + tr.sum()).backward()
    return float(count.get_total_flops())


def read(run):
    if run["kind"] != "pretrain" or not run["units"] or not run.get("spans"):
        return None
    from portbench.lib.peaks import FLOPS

    peak = FLOPS[run["spec"]["precision"]]
    return 100.0 * step_flops(run["settings"]) * run["units"] / run["window_s"] / peak
