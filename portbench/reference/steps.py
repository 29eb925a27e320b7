"""The reference's steps, in float32 with TF32 off: one online-adaptation
frame (frozen encoders once, then K iterations of decoders, loss, backward
and Adam over the decoders, and the online row's pooled depth-encoder
embedding), and one pretraining step (batch norm in train mode, Adam over
every parameter).

Adam is written out (b1 0.9, b2 0.999, eps 1e-8, bias-corrected), as CL-SLAM's
torch.optim.Adam computes it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference.loss import frame, view_synthesis_loss
from portbench.reference.nets import DepthPoseNet


def no_tf32(enabled: bool = True) -> None:
    """TF32 off (the float32 reference) or on (the control of a float32
    configuration)."""
    torch.backends.cuda.matmul.allow_tf32 = not enabled
    torch.backends.cudnn.allow_tf32 = not enabled


class Adam:
    """Adam from zero moments, or from given moments `m`, `v` after `t` steps.
    `first_grad_norms` keeps each gradient's norm at the first step taken."""

    def __init__(self, params: List[torch.Tensor], lr: float, m=None, v=None, t: int = 0):
        self.params, self.lr, self.t = list(params), lr, t
        self.m = [x.clone() for x in m] if m else [torch.zeros_like(p) for p in self.params]
        self.v = [x.clone() for x in v] if v else [torch.zeros_like(p) for p in self.params]
        self.first_grad_norms = None

    @torch.no_grad()
    def step(self) -> None:
        if self.first_grad_norms is None:
            self.first_grad_norms = [float(p.grad.norm()) for p in self.params]
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + 1e-8))
            p.grad = None


def build(state_dict: Dict[str, torch.Tensor], scales, device, precision: str = "float32",
          resnet_depth: int = 18, resnet_pose: int = 18) -> DepthPoseNet:
    net = DepthPoseNet(scales, resnet_depth, precision, resnet_pose).to(device)
    net.load_state_dict(state_dict)
    return net.eval()


def pose_pairs(rgb_aug: torch.Tensor) -> torch.Tensor:
    prev = torch.cat([frame(rgb_aug, -1), frame(rgb_aug, 0)], -1)
    nxt = torch.cat([frame(rgb_aug, 0), frame(rgb_aug, 1)], -1)
    return torch.cat([prev, nxt])


def pooled(feature: torch.Tensor) -> torch.Tensor:
    f = feature.mean((2, 3))
    return f / torch.clamp_min(torch.linalg.vector_norm(f, dim=-1, keepdim=True), 1e-12)


def _loss(net, batch, depth_feats, pose_feat, cfg, rng):
    disps = net.depth_decoder(depth_feats)
    aa, tr = net.pose_decoder(pose_feat)
    return view_synthesis_loss(disps, aa, tr, batch["rgb"], batch["K"], batch["rel_dist"],
                               batch["weights"], cfg["scales"], cfg["min_depth"],
                               cfg["max_depth"], cfg["disparity_smoothness"],
                               cfg["velocity_loss_scaling"], rng,
                               cfg.get("warp_storage", "float32"))


def adapt_frame(net: DepthPoseNet, opt: Adam, batch: Dict[str, torch.Tensor], cfg: dict,
                iterations: int, rng: Optional[torch.Generator]):
    """One adapted frame in place.  Returns the losses of each iteration
    (computed before its Adam step), the online row's T(0 -> +1) of the last
    iteration, and the online row's replay embedding."""
    with torch.no_grad():
        depth_feats = net.depth_encoder(frame(batch["rgb_aug"], 0))
        pose_feat = net.pose_encoder(pose_pairs(batch["rgb_aug"]))[-1]
    losses = []
    for _ in range(iterations):
        out, T_next = _loss(net, batch, depth_feats, pose_feat, cfg, rng)
        out["loss"].backward()
        opt.step()
        losses.append(out["loss"].detach())
    return torch.stack(losses), T_next[0].detach(), pooled(depth_feats[-1])[0]


@torch.no_grad()
def serve_frame(net: DepthPoseNet, batch: Dict[str, torch.Tensor], cfg: dict):
    """One served frame: the frozen encoders and the decoders' forward once,
    with no tie-break noise.  Returns the losses, the online row's
    T(0 -> +1) and its replay embedding."""
    depth_feats = net.depth_encoder(frame(batch["rgb_aug"], 0))
    pose_feat = net.pose_encoder(pose_pairs(batch["rgb_aug"]))[-1]
    out, T_next = _loss(net, batch, depth_feats, pose_feat, cfg, None)
    return out, T_next[0], pooled(depth_feats[-1])[0]


def stagewise(net: DepthPoseNet, batch: Dict[str, torch.Tensor], cfg: dict,
              decoder_weights: List[Dict[str, torch.Tensor]], rng: Optional[torch.Generator]):
    """Each adaptation iteration's forward from the decoder weights it ran
    with (the program's, one state per iteration): the losses (K,), the last
    iteration's T(0 -> +1) of the online row, and the first iteration's
    gradient norm of every decoder leaf."""
    params = dict(net.named_parameters())
    with torch.no_grad():
        depth_feats = net.depth_encoder(frame(batch["rgb_aug"], 0))
        pose_feat = net.pose_encoder(pose_pairs(batch["rgb_aug"]))[-1]
    losses, grads, T_next = [], {}, None
    for i, weights in enumerate(decoder_weights):
        with torch.no_grad():
            for n, w in weights.items():
                params[n].copy_(w)
        out, T_next = _loss(net, batch, depth_feats, pose_feat, cfg, rng)
        if i == 0:
            out["loss"].backward()
            grads = {n: float(params[n].grad.norm()) for n in weights}
            for n in weights:
                params[n].grad = None
        losses.append(out["loss"].detach())
    return torch.stack(losses), T_next[0].detach(), grads


def train_step(net: DepthPoseNet, opt: Adam, batch: Dict[str, torch.Tensor], cfg: dict,
               rng: Optional[torch.Generator]):
    """One pretraining step in place: the whole network with batch norm in
    train mode (the pose encoder's statistics over the 2B pairs), backward,
    Adam.  Returns the losses."""
    net.train()
    depth_feats = net.depth_encoder(frame(batch["rgb_aug"], 0))
    pose_feat = net.pose_encoder(pose_pairs(batch["rgb_aug"]))[-1]
    out, _ = _loss(net, batch, depth_feats, pose_feat, cfg, rng)
    out["loss"].backward()
    opt.step()
    net.eval()
    return {k: v.detach() for k, v in out.items()}
