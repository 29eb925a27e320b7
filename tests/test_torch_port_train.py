"""The training step of the PyTorch port (`forward` with batch norm in train
mode, `train_step`) against the JAX package.

The same weights (drawn by the port, read into flax trees by the JAX
package's importer, and carried back into a second port model by
`load_jax_variables`) and the same numpy frames go to both; networks are
float32 and warps store float32.  Three routes: the plain sampler at
32 x 64 (here), the same with `mask_dynamic` and a dynamic-object mask, and
`use_pallas_warp` at 48 x 384, inside the JAX package's gate, where its
Pallas kernel runs in interpret mode and the port runs K1's plain version
(both in `test_torch_port_train_routes.py`).

Kinks of the loss (ROADMAP Queue 3, `test_torch_port_fused_steps.py`) move a
pixel's gradient by O(1) on a rounding difference, and a parameter's gradient
sums every pixel.  So both sides get the same decisive identity candidate in
place of `identity_reprojection` (a test-side patch of both packages): -1,
which wins and passes no gradient, at each pixel where the two warped
candidates are within 1e-3 at some scale, a warped channel is within 1e-3 of
the target, or a warp coordinate of the pixel or of its SSIM window lies
within 2e-4 px of an integer; 10, which never wins, elsewhere.  With it the
JAX step's tie-break noise (1e-5, from `jax.random`, always on in its
`train_step`) cannot move the min, and the port's noise is off.
"""
import copy
import dataclasses

import numpy as np
import optax
import pytest
import torch
from scipy.ndimage import maximum_filter

import jax
import jax.numpy as jnp

import tpuslam.losses.photometric as jax_photometric
import tpuslam_torch.losses.photometric as photometric
from tpuslam.geometry.camera import normalize_pixel_coords as jax_normalize
from tpuslam.geometry.camera import warp_frame as jax_warp_frame
from tpuslam.checkpoint.torch_import import (_import_depth_decoder, _import_pose_decoder,
                                             _import_resnet)
from tpuslam.models import DepthPoseNet as JaxNet
from tpuslam.train import LossConfig as JaxLossConfig
from tpuslam.train import make_frame_batch as jax_batch
from tpuslam.train import make_train_state as jax_state
from tpuslam.train.state import make_adapt_optimizer as jax_adapt_optimizer
from tpuslam.train.state import make_pretrain_optimizer as jax_pretrain_optimizer
from tpuslam.train.state import steplr as jax_steplr
from tpuslam.train.steps import forward as jax_forward
from tpuslam.train.steps import train_step as jax_train_step
from tpuslam_torch.checkpoint.from_jax import jax_to_state_dict, load_jax_variables
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.geometry.camera import (backproject_depth, normalize_pixel_coords,
                                           pixel_grid, project_3d, resize_bilinear, warp_frame)
from tpuslam_torch.geometry.depth import disp_to_depth
from tpuslam_torch.losses.photometric import reprojection_loss
from tpuslam_torch.models.depth_pose import DepthPoseNet, init_depth_pose
from tpuslam_torch.train.batch import make_frame_batch
from tpuslam_torch.train.state import (make_adapt_optimizer, make_pretrain_optimizer,
                                       make_train_state, set_learning_rate, steplr)
from tpuslam_torch.train.steps import LossConfig, forward, train_step

torch.set_num_threads(1)

SCALES = (0, 1)
ROUTES = {
    # H, W, B, mask, LossConfig flags
    "plain": (32, 64, 2, False, dict(use_pallas_warp=False)),
    "mask_dynamic": (32, 64, 2, True, dict(use_pallas_warp=False, mask_dynamic=True)),
    "pallas_warp": (48, 384, 1, False, dict(use_pallas_warp=True)),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _flat(tree):
    return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])


def _flax_variables(net):
    """The flax (params, batch_stats) of a port `DepthPoseNet`, through the
    JAX package's importer of monodepth2 state dicts (flax's own init costs
    ~30 s of op-by-op compiles on the CPU)."""
    params, stats = {}, {}
    for enc in ("depth_encoder", "pose_encoder"):
        params[enc], stats[enc] = _import_resnet(getattr(net, enc).state_dict())
    params["depth_decoder"] = _import_depth_decoder(net.depth_decoder.state_dict())
    params["pose_decoder"] = _import_pose_decoder(net.pose_decoder.state_dict())
    return params, stats


def _decisive_identity(model, batch, cfg):
    """The identity candidate of the module docstring, from the port's
    train-mode forward on a copy of `model` (its BN statistics untouched)."""
    H, W, B = batch.height, batch.width, batch.batch_size
    with torch.no_grad():
        _, out = forward(copy.deepcopy(model), batch, cfg, train_bn=True)
        target = batch.frame(0)
        tie = np.zeros((B, H, W), bool)
        flip = np.zeros((B, H, W), bool)
        pix = pixel_grid(H, W)
        for s in SCALES:
            e = [reprojection_loss(out[("rgb", f, s)], target).numpy() for f in (-1, 1)]
            tie |= np.abs(e[0] - e[1]) < 1e-3
            depth = disp_to_depth(resize_bilinear(out[("disp", s)], H, W), 0.1, None)
            points = backproject_depth(depth, batch.inv_K, pix)
            for f in (-1, 1):
                tie |= (out[("rgb", f, s)] - target).abs().amin(-1).numpy() < 1e-3
                coords = project_3d(points, batch.K, out[("cam_T_cam", 0, f)], H, W).numpy()
                flip |= (np.abs(coords - np.round(coords)) < 2e-4).any(-1)
    tie |= maximum_filter(flip, size=(1, 3, 3))
    assert tie.mean() < 0.6
    return np.where(tie[:, None], -1.0, 10.0).repeat(2, axis=1).astype(np.float32)


def _run(route):
    """Both packages from the same variables and batch: the gradient of one
    train-mode forward (JAX: `forward` under `value_and_grad`; port: the
    `.grad` that `train_step` leaves), the BN statistics after one
    `train_step`, the parameters after two."""
    H, W, B, with_mask, flags = ROUTES[route]
    rng = np.random.default_rng(5)
    ds = SyntheticDataset(num_frames=B + 1, height=H, width=W, do_augmentation=True)
    samples = [ds[i] for i in range(B)]
    rgb = np.stack([s.rgb for s in samples])
    aug = np.stack([s.aug for s in samples])
    rel = np.stack([s.rel_dist for s in samples])
    mask = None
    if with_mask:  # blocks of 2 x 2 that are half dynamic round to static (half to even)
        mask = (rng.uniform(size=(B, H, W)) < 0.3).astype(np.float32)
    model, params, stats = JaxNet(), *_flax_variables(init_depth_pose(0, device="cpu"))
    # a pose head bias of a few px of motion: at random init the poses are
    # ~0 and every warp coordinate sits on a tap boundary
    bias = params["pose_decoder"]["pose_2"]["bias"]
    params["pose_decoder"]["pose_2"]["bias"] = rng.normal(scale=0.5, size=bias.shape).astype(
        np.float32)
    port = init_depth_pose(1, device="cpu")
    load_jax_variables(port, params, stats)
    tb = make_frame_batch(rgb, ds.K, rel, rgb_aug=aug, mask=mask, device="cpu")
    jb = jax_batch(rgb, ds.K, rel, rgb_aug=aug, mask=mask)
    tcfg = LossConfig(scales=SCALES, pallas_bf16_out=False, bf16_networks=False, **flags)
    jcfg = JaxLossConfig(scales=SCALES, pallas_bf16_out=False, **flags)
    identity = _decisive_identity(port, tb, tcfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_photometric, "identity_reprojection",
                   lambda inputs, frame_ids=(0, -1, 1): jnp.asarray(identity))
        mp.setattr(photometric, "identity_reprojection",
                   lambda inputs, frame_ids=(0, -1, 1): torch.from_numpy(identity))

        def loss_fn(p, st):
            losses, _, new_stats = jax_forward(model, p, st, jb, jcfg, train_bn=True)
            return losses["loss"], (losses, new_stats)

        # the body of the JAX `train_step` with its noise off: forward with
        # train-mode BN, gradient, Adam (one compile for both steps)
        grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        tx = jax_pretrain_optimizer(1e-4)

        @jax.jit
        def adam(g, opt, p):
            updates, opt = tx.update(g, opt, p)
            return optax.apply_updates(p, updates), opt

        jp, jst, jopt = params, stats, tx.init(params)
        for i in range(2):
            (_, (losses, jst)), grads = grad(jp, jst)
            jp, jopt = adam(grads, jopt, jp)
            if i == 0:
                jlosses, jgrads, jstats = losses, grads, jst
        if route == "plain":  # the JAX `train_step` itself, its noise on
            jstate = jax_state(params, stats, tx)
            for _ in range(2):
                jstate, _ = jax_train_step(model, tx, jcfg, jstate, jb)
            assert _rel(_flat(jstate.params), _flat(jp)) < 1e-4
            jp = jstate.params

        start = copy.deepcopy(port)
        state = make_train_state(port, make_pretrain_optimizer(port, 1e-4), seed=None)
        tlosses = train_step(state, tcfg, tb)
        # the depth decoder's heads of scales 2 and 3 are unused at SCALES
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
                 for k, p in port.named_parameters()}
        stats1 = {k: v.numpy().copy() for k, v in port.state_dict().items()
                  if "running" in k}
        train_step(state, tcfg, tb)
    return dict(
        jlosses=jlosses, tlosses=tlosses, grads=grads, stats1=stats1,
        jgrads=jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads), stats),
        jstats1=jax_to_state_dict(params, jax.tree_util.tree_map(np.asarray, jstats)),
        jparams2=jax_to_state_dict(jax.tree_util.tree_map(np.asarray, jp), stats),
        params2={k: v.detach().numpy() for k, v in port.named_parameters()},
        before=jax_to_state_dict(params, stats), mode=port.training,
        start=start, batch=tb, cfg=tcfg, identity=identity)


@pytest.fixture(scope="module", params=["plain"])
def run(request):
    return request.param, _run(request.param)


# Relative error allowed between the two packages' gradients of each
# network (all its parameters as one vector), and between either package's
# float32 gradient and the float64 one of the same step
# (`test_gradients_against_float64`).  Batch norm in train mode over a few
# values per channel in the deep layers (4 per channel in layer 4 of the
# depth encoder at 32 x 64, batch 2) amplifies float32 rounding in the
# encoders: measured from float64 (port / JAX), the depth encoder 5.8e-5 /
# 6.8e-5 at 32 x 64 and 8.0e-4 / 8.0e-4 at 48 x 384; the pose encoder
# 2.7e-5 / 3.4e-3 at 32 x 64 (1.3e-3 for JAX with `mask_dynamic`) and
# 5.4e-3 / 1.1e-3 at 48 x 384.  The decoders stay within 1.6e-5 of float64
# on both sides at 32 x 64; at 48 x 384 the JAX package's pose decoder
# (its Pallas warp in interpret mode) is 1.2e-4 from float64 and the port's
# 4.9e-5, so the two packages differ by 1.24e-4 there.
DECODER_TOL = {
    "plain": {"depth_decoder": 1e-4, "pose_decoder": 1e-4},
    "mask_dynamic": {"depth_decoder": 1e-4, "pose_decoder": 1e-4},
    "pallas_warp": {"depth_decoder": 1e-4, "pose_decoder": 3e-4},
}
ENCODER_TOL = {
    "plain": {"depth_encoder": 1e-4, "pose_encoder": 1e-2},
    "mask_dynamic": {"depth_encoder": 1e-4, "pose_encoder": 1e-2},
    "pallas_warp": {"depth_encoder": 3e-3, "pose_encoder": 1e-2},
}


def test_train_step_losses_and_gradients(run):
    """Every loss term within 1e-5 relative; the gradient of each network
    (all its parameters as one vector) within `DECODER_TOL` /
    `ENCODER_TOL`; every parameter has a gradient, encoders and their
    batch-norm scale and bias included; the model back in eval mode after
    the step."""
    route, r = run
    for k, want in r["jlosses"].items():
        assert _rel(r["tlosses"][k], want) < 1e-5, (route, k)
    assert set(r["grads"]) == {k for k in r["jgrads"] if "running" not in k}
    tol = {**DECODER_TOL[route], **ENCODER_TOL[route]}
    for net, limit in tol.items():
        keys = [k for k in r["grads"] if k.startswith(net)]
        err = _rel(np.concatenate([r["grads"][k].ravel() for k in keys]),
                   np.concatenate([r["jgrads"][k].ravel() for k in keys]))
        assert err < limit, (route, net, err)
    for k, g in r["grads"].items():
        used = "dispconv_2" not in k and "dispconv_3" not in k
        assert (np.abs(g).max() > 0) == used, k
    assert r["mode"] is False


def test_gradients_against_float64(run):
    """Both packages' float32 gradients against the port's float64 gradient
    of the same step (the port run in float64 end to end): each network
    within the bound `DECODER_TOL` / `ENCODER_TOL` set for the two packages'
    difference, so that those bounds are the float32 rounding of the step,
    of either package, and not a difference between them."""
    route, r = run
    b = r["batch"]
    to64 = {f.name: getattr(b, f.name).double() for f in dataclasses.fields(b)
            if getattr(b, f.name) is not None and getattr(b, f.name).is_floating_point()}
    batch = dataclasses.replace(b, rgb=b.rgb.double() / 255, rgb_aug=b.rgb_aug.double() / 255,
                                **{k: v for k, v in to64.items() if k not in ("rgb", "rgb_aug")})
    model = copy.deepcopy(r["start"]).double()
    identity = torch.from_numpy(r["identity"]).double()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(photometric, "identity_reprojection",
                   lambda inputs, frame_ids=(0, -1, 1): identity)
        cfg = r["cfg"]._replace(use_pallas_warp=False)  # the kernels take float32 only
        losses, _ = forward(model, batch, cfg, train_bn=True)
    losses["loss"].backward()
    g64 = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for k, p in model.named_parameters()}
    tol = {**DECODER_TOL[route], **ENCODER_TOL[route]}
    for net, limit in tol.items():
        keys = [k for k in g64 if k.startswith(net)]
        want = np.concatenate([g64[k].ravel() for k in keys])
        for side in ("grads", "jgrads"):
            got = np.concatenate([r[side][k].ravel() for k in keys])
            assert _rel(got, want) < limit, (route, net, side, _rel(got, want))


def test_train_step_bn_running_statistics(run):
    """Running mean and variance of every batch-norm layer after one step
    within 1e-5: flax's rule (momentum 0.9, the biased batch variance), not
    torch's unbiased one, which is n / (n - 1) larger (4 / 3 in layer 4 of the
    depth encoder at 32 x 64, batch 2)."""
    route, r = run
    assert len(r["stats1"]) == 2 * 2 * 20  # two encoders, 20 BN layers each in ResNet-18
    for k, got in r["stats1"].items():
        np.testing.assert_allclose(got, r["jstats1"][k], rtol=0, atol=1e-5,
                                   err_msg=f"{route}: {k}")
        if k.endswith("running_var"):
            assert not np.allclose(got, 1.0), k


def test_train_step_parameters_after_two_steps(run):
    """The parameters after two Adam steps (as one vector per network)
    within 5e-4 relative, and every network moved.  Adam's first steps move
    each weight by about lr times the sign of its gradient, so each weight
    whose gradient is within rounding of 0 moves by lr either way: on these
    inputs the updates of a network differ by 0.3-7% between the packages
    (the adapt parity tests see the same), and the parameters by up to
    2.6e-4."""
    route, r = run
    for net in ("depth_encoder", "pose_encoder", "depth_decoder", "pose_decoder"):
        keys = [k for k in r["params2"] if k.startswith(net)]
        got = np.concatenate([r["params2"][k].ravel() for k in keys])
        want = np.concatenate([r["jparams2"][k].ravel() for k in keys])
        before = np.concatenate([r["before"][k].ravel() for k in keys])
        assert _rel(got, want) < 5e-4, (route, net)
        assert not np.allclose(want, before, rtol=0, atol=1e-6), (route, net)


def test_steplr_and_set_learning_rate():
    """The JAX `steplr` over epochs 1-30 at step sizes 1, 12 and 15 (the
    epoch counts from 1, not torch StepLR's 0), and `set_learning_rate` on
    every parameter group."""
    for step_size in (1, 12, 15):
        want, got = jax_steplr(1e-4, step_size), steplr(1e-4, step_size)
        for epoch in range(1, 31):
            assert got(epoch) == pytest.approx(want(epoch), rel=1e-12), (step_size, epoch)
    assert steplr(1e-4, 15)(14) == 1e-4 and steplr(1e-4, 15)(15) == pytest.approx(1e-5)
    net = DepthPoseNet(scales=SCALES)
    opt = make_adapt_optimizer(net, 1e-4, depth_lr_scale=0.5)
    set_learning_rate(opt, 3e-5)
    assert [g["lr"] for g in opt.param_groups] == [3e-5, 3e-5]
    opt = make_pretrain_optimizer(net, 1e-4)
    assert sum(p.numel() for g in opt.param_groups for p in g["params"]) == sum(
        p.numel() for p in net.parameters())


@pytest.mark.parametrize("depth_lr_scale", [1.0, 0.5])
def test_grad_clip_norm_matches_optax(depth_lr_scale):
    """`make_adapt_optimizer(grad_clip_norm=...)` against the JAX package's
    (`optax.clip_by_global_norm` before Adam): of both decoders together, or
    of each head on its own when `depth_lr_scale` splits them.  Two steps,
    the first gradient above the norm and the second below it; the updates
    within 1e-5 relative."""
    rng = np.random.default_rng(7)
    net = DepthPoseNet(scales=SCALES)
    named = {k: p for k, p in net.named_parameters() if "decoder" in k}
    opt = make_adapt_optimizer(net, 1e-3, depth_lr_scale, grad_clip_norm=1.0)
    flat = {k: p.detach().numpy().copy() for k, p in named.items()}
    tree = {"depth_decoder": {k: v for k, v in flat.items() if k.startswith("depth")},
            "pose_decoder": {k: v for k, v in flat.items() if k.startswith("pose")},
            "depth_encoder": {"w": np.zeros(3, np.float32)}}
    tx = jax_adapt_optimizer(tree, 1e-3, grad_clip_norm=1.0, depth_lr_scale=depth_lr_scale)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = tx.init(jparams)
    update = jax.jit(tx.update)
    for scale in (1.0, 1e-4):  # a norm of ~30, then ~3e-3
        g = {k: (scale * rng.normal(size=v.shape) / np.sqrt(len(named))).astype(np.float32)
             for k, v in flat.items()}
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        jg = {"depth_decoder": {k: g[k] for k in tree["depth_decoder"]},
              "pose_decoder": {k: g[k] for k in tree["pose_decoder"]},
              "depth_encoder": {"w": np.ones(3, np.float32)}}
        updates, jopt = update(jax.tree_util.tree_map(jnp.asarray, jg), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
    got = np.concatenate([(p.detach().numpy() - flat[k]).ravel() for k, p in named.items()])
    want = np.concatenate([(np.asarray(jparams[k.split(".")[0]][k]) - flat[k]).ravel()
                           for k in named])
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(np.asarray(jparams["depth_encoder"]["w"]), 0.0)


def test_warp_frame_and_normalize_pixel_coords(rng):
    """`warp_frame` and `normalize_pixel_coords` against `tpuslam.geometry`
    on the same inputs (a textured source, a depth map, a small motion)."""
    B, H, W = 2, 24, 40
    src = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    depth = rng.uniform(2.0, 6.0, size=(B, H, W)).astype(np.float32)
    K = np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    T[:, :3, 3] = rng.normal(scale=0.05, size=(B, 3))
    Ks, inv_Ks = np.tile(K, (B, 1, 1)), np.tile(np.linalg.inv(K), (B, 1, 1))
    want = jax_warp_frame(*(jnp.asarray(x) for x in (src, depth, Ks, inv_Ks, T)),
                          height=H, width=W)
    got = warp_frame(*(torch.from_numpy(x) for x in (src, depth, Ks, inv_Ks, T)),
                     height=H, width=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    coords = rng.uniform(-5, W + 5, size=(B, H, W, 2)).astype(np.float32)
    np.testing.assert_allclose(normalize_pixel_coords(torch.from_numpy(coords), H, W).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(coords), H, W)),
                               rtol=1e-6, atol=1e-6)
