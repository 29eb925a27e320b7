"""The fused warp -> loss stack of the PyTorch port (`warp_and_loss` and
`adapt_step` under `pallas_tall`, `pallas_proj`, `pallas_fused_loss` and
`pallas_fused_bwd`) against the JAX package.

At 32 x 384 the JAX functions run their Pallas kernels in interpret mode
(float32 storage); the port runs the kernels' plain versions.  The same numpy
inputs go to both.

Three kinds of pixel move the gradient by O(1) on a difference of rounding
(ROADMAP Queue 3), each a kink of the loss: min-reprojection near-ties,
where two error candidates are within ~1e-4 and a 1e-7 difference picks the
other branch; L1 near-ties, where a warped channel is within ~1e-5 of the
target and |y - x| flips its slope; and tap boundaries, where a warp
coordinate lies within ~1e-5 px of an integer and the two sides floor it
differently, so the bilinear derivative jumps (the JAX package's in-kernel
projection moves coordinates by ~1e-4 px).  The warp_and_loss comparisons
take them out of the min on both sides: the identity candidate is -1 at
every pixel where the two warped candidates are within 1e-3 at some scale,
a warped channel is within 1e-3 of the target, or a coordinate of the pixel
or of its SSIM window lies within 2e-4 px of an integer (so it wins there,
and the pixel passes no gradient), and 10 elsewhere (so it never wins).
Every other pixel's choice, slope and taps then have a margin far above the
implementations' difference, and gradients compare to rounding.
"""
import numpy as np
import pytest
import torch
from scipy.ndimage import maximum_filter

import jax
import jax.numpy as jnp

from tpuslam.models import init_depth_pose as jax_init
from tpuslam.train import LossConfig as JaxLossConfig
from tpuslam.train import adapt_step as jax_adapt_step
from tpuslam.train import make_adapt_optimizer as jax_optimizer
from tpuslam.train import make_frame_batch as jax_batch
from tpuslam.train import make_train_state as jax_state
from tpuslam.train.steps import warp_and_loss as jax_warp_and_loss
from tpuslam_torch.checkpoint.from_jax import jax_to_state_dict, load_jax_variables
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.geometry.camera import (backproject_depth, pixel_grid, project_3d,
                                           resize_bilinear)
from tpuslam_torch.geometry.depth import disp_to_depth
from tpuslam_torch.geometry.se3 import transformation_from_parameters
from tpuslam_torch.losses.photometric import reprojection_loss
from tpuslam_torch.models.depth_pose import init_depth_pose
from tpuslam_torch.train.batch import make_frame_batch
from tpuslam_torch.train.state import make_adapt_optimizer, make_train_state
from tpuslam_torch.train.steps import LossConfig, adapt_step, warp_and_loss

torch.set_num_threads(1)

H, W, B, SCALES = 32, 384, 2, (0, 1)
FLAGS = ("pallas_tall", "pallas_proj", "pallas_fused_loss", "pallas_fused_bwd")
COMBOS = {
    "tall": dict(pallas_tall=True),
    "tall+proj": dict(pallas_tall=True, pallas_proj=True),
    "fused_loss": dict(pallas_fused_loss=True),
    "tall+fused_loss": dict(pallas_tall=True, pallas_fused_loss=True),
    "tall+fused_loss+fused_bwd": dict(pallas_tall=True, pallas_fused_loss=True,
                                      pallas_fused_bwd=True),
    "full stack": dict(zip(FLAGS, (True,) * 4)),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


@pytest.fixture(scope="module")
def inputs():
    """Textured frames, decoder outputs and the decisive identity candidate
    (module docstring), as numpy."""
    rng = np.random.default_rng(3)
    ds = SyntheticDataset(num_frames=B + 1, height=H, width=W)
    rel = np.stack([ds[i].rel_dist for i in range(B)])
    rgb = rng.uniform(size=(B, 3, H, W, 3)).astype(np.float32)
    disps = {s: rng.uniform(0.3, 0.6, (B, H >> s, W >> s, 1)).astype(np.float32)
             for s in SCALES}
    aa = rng.normal(scale=1e-3, size=(2 * B, 3)).astype(np.float32)
    tr = rng.normal(scale=2e-2, size=(2 * B, 3)).astype(np.float32)
    batch = make_frame_batch(rgb, ds.K, rel, device="cpu")
    cfg = LossConfig(scales=SCALES, pallas_bf16_out=False, bf16_networks=False)
    with torch.no_grad():
        _, outputs = warp_and_loss(
            {("disp", s): torch.from_numpy(disps[s]) for s in SCALES},
            torch.from_numpy(aa), torch.from_numpy(tr), batch, cfg)
        tie = np.zeros((B, H, W), bool)
        for s in SCALES:
            e = [reprojection_loss(outputs[("rgb", f, s)], batch.frame(0)).numpy()
                 for f in (-1, 1)]
            tie |= np.abs(e[0] - e[1]) < 1e-3
            for f in (-1, 1):  # the L1 term's kink at pred = target
                tie |= (outputs[("rgb", f, s)] - batch.frame(0)).abs().amin(-1).numpy() < 1e-3
        # the warp coordinates of the (2*S*B, H, W, 2) stack, as warp_and_loss
        S = len(SCALES)
        a, t = torch.from_numpy(aa), torch.from_numpy(tr)
        T = torch.cat([transformation_from_parameters(a[:B], t[:B], invert=True).repeat(S, 1, 1),
                       transformation_from_parameters(a[B:], t[B:]).repeat(S, 1, 1)])
        depth = torch.cat([disp_to_depth(resize_bilinear(torch.from_numpy(disps[s]), H, W), 0.1,
                                         None) for s in SCALES])
        points = backproject_depth(depth, batch.inv_K.repeat(S, 1, 1), pixel_grid(H, W))
        coords = project_3d(points.repeat(2, 1, 1), batch.K.repeat(2 * S, 1, 1), T, H, W).numpy()
    # a flipped tap moves the pred pixel, and so the error of each pixel
    # whose 3x3 SSIM window holds it
    flip = (np.abs(coords - np.round(coords)) < 2e-4).any(-1).reshape(2 * S, B, H, W).any(0)
    tie |= maximum_filter(flip, size=(1, 3, 3))
    assert tie.mean() < 0.1
    identity = np.where(tie[:, None], -1.0, 10.0).repeat(2, axis=1).astype(np.float32)
    return dict(rgb=rgb, K=ds.K, rel=rel, disps=disps, aa=aa, tr=tr, identity=identity)


@pytest.mark.parametrize("combo", list(COMBOS))
def test_warp_and_loss_matches_jax_under_each_flag_combination(inputs, combo):
    """Each routing of the fused stack against JAX `warp_and_loss` with the
    same flags: losses within 1e-5 relative, gradients to the disparities
    (each scale) within 1e-4 relative, and to the pose outputs within 1e-3:
    they sum every pixel's contribution, and on these inputs the port's own
    float32 pose gradient is 2.3e-4 from its float64 value, so two float32
    implementations differ by ~5e-4."""
    flags = COMBOS[combo]
    d, aa, tr = inputs["disps"], inputs["aa"], inputs["tr"]
    jcfg = JaxLossConfig(scales=SCALES, use_pallas_warp=True, pallas_bf16_out=False, **flags)
    jb = jax_batch(inputs["rgb"], inputs["K"], inputs["rel"])
    jid = jnp.asarray(inputs["identity"])

    def jfn(dj, a, t):
        losses, _ = jax_warp_and_loss({("disp", s): dj[s] for s in SCALES}, a, t, jb, jcfg,
                                      identity_base=jid)
        return losses["loss"], losses

    # jitted, the interpret-mode kernels cost a third less than op by op
    (_, want), jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        {s: jnp.asarray(v) for s, v in d.items()}, jnp.asarray(aa), jnp.asarray(tr))

    tcfg = LossConfig(scales=SCALES, pallas_bf16_out=False, bf16_networks=False, **flags)
    td = {s: torch.from_numpy(v).requires_grad_() for s, v in d.items()}
    ta, tt = (torch.from_numpy(x).requires_grad_() for x in (aa, tr))
    tb = make_frame_batch(inputs["rgb"], inputs["K"], inputs["rel"], device="cpu")
    got, outputs = warp_and_loss({("disp", s): td[s] for s in SCALES}, ta, tt, tb, tcfg,
                                 identity_base=torch.from_numpy(inputs["identity"]))
    got["loss"].backward()
    for k in want:
        assert _rel(got[k].detach(), want[k]) < 1e-5, k
    for s in SCALES:
        assert _rel(td[s].grad, jg[0][s]) < 1e-4, f"d/d disp_{s}"
    assert _rel(ta.grad, jg[1]) < 1e-3 and _rel(tt.grad, jg[2]) < 1e-3
    # the composites hand back the warped stack detached, as the JAX one does
    detached = flags.get("pallas_fused_bwd", False)
    assert outputs[("rgb", -1, 0)].requires_grad is not detached


def test_full_stack_adapt_step_matches_jax():
    """One K = 2 `adapt_step` with the full fused stack at 64 x 384 (the
    port's depth decoder needs H >= 64: its reflection pad refuses the 1-row
    map of stage 4 at 32 rows), batch 1, from the same weights and synthetic
    frames on each side.  As in
    test_torch_port_adapt.py (whose JAX step adds identity noise from
    jax.random that the port cannot draw): losses and the packed readback
    within 1e-4 relative, updated decoder parameters within 1e-4 relative
    and their updates within 2e-2."""
    K_ITERS, h = 2, 64
    ds = SyntheticDataset(num_frames=3, height=h, width=W)
    rgb, rel = ds[1].rgb[None], ds[1].rel_dist[None]
    model, variables = jax_init(jax.random.PRNGKey(0), height=h, width=W, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    tx = jax_optimizer(params, 1e-4)
    flags = COMBOS["full stack"]
    jcfg = JaxLossConfig(scales=SCALES, use_pallas_warp=True, pallas_bf16_out=False, **flags)
    jstate, jlosses, jout = jax_adapt_step(
        model, tx, jcfg, jax_state(params, stats, tx), None, jax_batch(rgb, ds.K, rel),
        num_steps=K_ITERS, with_lc_embedding=False)

    port = init_depth_pose(0, device="cpu")
    load_jax_variables(port, params, stats)
    state = make_train_state(port, make_adapt_optimizer(port, 1e-4), seed=None)
    tcfg = LossConfig(scales=SCALES, pallas_bf16_out=False, bf16_networks=False, **flags)
    tlosses, tout = adapt_step(state, tcfg, make_frame_batch(rgb, ds.K, rel, device="cpu"),
                               num_steps=K_ITERS, with_lc_embedding=False)
    for k in ("loss", "depth_loss", "velocity_loss"):
        assert _rel(tlosses[k], jlosses[k]) < 1e-4, k
    assert _rel(tlosses["iter_losses"], jlosses["iter_losses"]) < 1e-4
    assert _rel(tout[("retire_packed",)], jout[("retire_packed",)]) < 1e-4
    before = jax_to_state_dict(params, stats)
    want = jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                             jstate.batch_stats)
    got = {k: v.numpy() for k, v in port.state_dict().items()}
    dec = [k for k in want if "decoder" in k]
    assert _rel(np.concatenate([got[k].ravel() for k in dec]),
                np.concatenate([want[k].ravel() for k in dec])) < 1e-4
    assert _rel(np.concatenate([(got[k] - before[k]).ravel() for k in dec]),
                np.concatenate([(want[k] - before[k]).ravel() for k in dec])) < 2e-2
