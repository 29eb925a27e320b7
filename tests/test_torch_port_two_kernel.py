"""The two-kernel warps of the PyTorch port (K2 `warp_two_kernel` in all five
variants, K3/K3' `warp_dynamic`) and the storage rules of `warp_and_loss`
against the JAX package.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode (`pallas_warp_static(..., interpret=
True)`, `pallas_warp(..., interpret=True)`).  The same numpy inputs go to
both.  The TPU kernels are exact only inside their source window, so the
inputs keep the flow there: at 24 x 384 with `extra_tiles=1` the static
window is the whole image, and at 32 x 256 the dynamic window spans every
column and 16 rows around each tile's lowest row.

`warp_and_loss` stores bf16 and truncates taps only where the JAX package
runs its kernels (H % 8 == 0, W % 128 == 0, W >= 384, and H >= 8 + 16 *
`pallas_extra_tiles` for the static ones): with `pallas_fused_grad` off the
JAX package's two-kernel warp stores f32 whatever `pallas_bf16_out` says,
and below the gate its sampler is f32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuslam.ops.pallas_warp import pallas_warp, pallas_warp_static
from tpuslam.train import LossConfig as JaxLossConfig
from tpuslam.train import make_frame_batch as jax_batch
from tpuslam.train.steps import warp_and_loss as jax_warp_and_loss
from tpuslam_torch.data.synthetic import SyntheticDataset
from tpuslam_torch.ops import warp as wp
from tpuslam_torch.train.batch import make_frame_batch
from tpuslam_torch.train.steps import LossConfig, warp_and_loss

torch.set_num_threads(1)

# pallas_warp_static's (sparse, packed, seg_skip, group_skip) per variant,
# and whether its taps are truncated to bf16
VARIANTS = {
    "dense": ((False, False, False, False), False),
    "sparse": ((True, False, False, False), False),
    "group_skip": ((False, False, False, True), False),
    "packed": ((False, True, False, False), True),
    "seg_skip": ((False, False, True, False), True),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _warp_inputs(rng, B, H, W, shift, edges):
    """Sources in [0, 1] with fine texture (so truncation shows), smooth
    flow of amplitude `shift` plus +-1 px noise; with `edges`, points left
    of and below the image, exact-edge ties and integer coordinates."""
    src = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    dx = shift * np.sin(gy / H * 3.0) + rng.uniform(-1, 1, (B, H, W))
    dy = shift * np.cos(gx / W * 2.0) + rng.uniform(-1, 1, (B, H, W))
    coords = np.stack([gx + dx, gy + dy], axis=-1).astype(np.float32)
    if edges:
        coords[:, :, :3, 0] = -2.5  # outside: no gradient
        coords[:, :, 3, 0] = 0.0  # exact left edge: half the gradient
        coords[:, :, -1, 0] = W - 1.0  # exact right edge
        coords[:, 2, :, 1] = H + 7.0  # below the image
        coords[:, 0, :, 1] = 0.0  # exact top edge
        coords[:, 5:7] = np.floor(coords[:, 5:7])  # integer coordinates
    g = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    return src, coords, g


def _jax_value_and_dcoords(fn, coords, g):
    out, vjp = jax.vjp(fn, jnp.asarray(coords))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port_value_and_dcoords(entry, src, coords, g, *args):
    c = torch.from_numpy(coords).requires_grad_()
    out = entry(torch.from_numpy(src), c, *args)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), c.grad.numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k2_matches_pallas_warp_static(rng, variant):
    """K2 forward values within 1e-6 absolute and dcoords within 1e-5
    relative of `pallas_warp_static` (interpret mode, extra_tiles=1) at
    24 x 384, edges and out-of-image points included.  Dense, sparse and
    group-skip read exact taps; packed and seg-skip truncated ones."""
    flags, trunc = VARIANTS[variant]
    src, coords, g = _warp_inputs(rng, 2, 24, 384, 4.0, edges=True)
    want = _jax_value_and_dcoords(
        jax.jit(lambda c: pallas_warp_static(jnp.asarray(src), c, True, 1, *flags)), coords, g)
    got = _port_value_and_dcoords(wp.warp_two_kernel, src, coords, g, trunc)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert _rel(got[1], want[1]) < 1e-5
    # the edge columns carry half of the interior subgradient, outside none
    assert np.all(got[1][:, :, :3, 0] == 0.0) and np.all(got[1][:, 2, :, 1] == 0.0)
    # truncation is what tells the variants apart
    exact = wp.warp_two_kernel_plain(torch.from_numpy(src), torch.from_numpy(coords)).numpy()
    assert (np.abs(got[0] - exact).max() > 1e-4) == trunc


def test_k3_matches_pallas_warp(rng):
    """K3/K3' (`warp_dynamic`, K2 with exact taps) against the dynamic-window
    `pallas_warp` (interpret mode) at 32 x 256: values within 1e-6
    absolute, dcoords within 1e-5 relative; exact-edge ties included."""
    src, coords, g = _warp_inputs(rng, 2, 32, 256, 2.0, edges=False)
    coords[:, :, 0, 0] = 0.0
    coords[:, :, -1, 0] = 255.0
    want = _jax_value_and_dcoords(
        jax.jit(lambda c: pallas_warp(jnp.asarray(src), c, True)), coords, g)
    got = _port_value_and_dcoords(wp.warp_dynamic, src, coords, g)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert _rel(got[1], want[1]) < 1e-5


def _loss_inputs(rng, H, W, B, scales):
    """Textured frames and decoder outputs, as test_torch_port_steps.py
    draws them (the flow stays inside the JAX static window at 48 x 384)."""
    ds = SyntheticDataset(num_frames=B + 1, height=H, width=W)
    rel = np.stack([ds[i].rel_dist for i in range(B)])
    rgb = rng.uniform(size=(B, 3, H, W, 3)).astype(np.float32)
    disps = {s: rng.uniform(0.3, 0.6, (B, H >> s, W >> s, 1)).astype(np.float32)
             for s in scales}
    aa = rng.normal(scale=1e-3, size=(2 * B, 3)).astype(np.float32)
    tr = rng.normal(scale=2e-2, size=(2 * B, 3)).astype(np.float32)
    return rgb, ds.K, rel, disps, aa, tr


def _losses_both(rng, H, W, flags):
    B, scales = 2, (0, 1)
    rgb, K, rel, disps, aa, tr = _loss_inputs(rng, H, W, B, scales)
    jcfg = JaxLossConfig(scales=scales, use_pallas_warp=True, **flags)
    want, _ = jax.jit(lambda d, a, t: jax_warp_and_loss(
        {("disp", s): d[s] for s in scales}, a, t, jax_batch(rgb, K, rel), jcfg))(
        {s: jnp.asarray(v) for s, v in disps.items()}, jnp.asarray(aa), jnp.asarray(tr))
    tcfg = LossConfig(scales=scales, use_pallas_warp=True, bf16_networks=False, **flags)
    with torch.no_grad():
        got, outputs = warp_and_loss({("disp", s): torch.from_numpy(disps[s]) for s in scales},
                                     torch.from_numpy(aa), torch.from_numpy(tr),
                                     make_frame_batch(rgb, K, rel, device="cpu"), tcfg)
    return got, want, outputs


@pytest.mark.parametrize("flags", [
    dict(pallas_fused_grad=False, pallas_bf16_out=True),
    dict(pallas_packed=True, pallas_bf16_out=True),
], ids=["two_kernel", "packed"])
def test_warp_and_loss_two_kernel_route_matches_jax(rng, flags):
    """48 x 384 (inside the JAX gate), bf16 storage requested: the JAX
    package takes its two-kernel warp, which stores f32 (and, packed,
    truncates the taps), so the port's losses agree within 1e-5 relative;
    storing bf16 there, as K1 would, misses by more."""
    got, want, outputs = _losses_both(rng, 48, 384, flags)
    assert outputs[("rgb", -1, 0)].dtype == torch.float32
    for k in want:
        assert _rel(got[k], want[k]) < 1e-5, k


@pytest.mark.parametrize("flags", [
    dict(),
    dict(pallas_fused_grad=False),
    dict(pallas_tall=True),
    dict(pallas_tall=True, pallas_proj=True, pallas_fused_loss=True, pallas_fused_bwd=True),
], ids=["fused_grad", "two_kernel", "tall", "fused_stack"])
def test_warp_and_loss_below_the_gate_stores_f32(rng, flags):
    """64 x 192 (W < 384: the JAX package runs its f32 sampler) with
    `pallas_bf16_out=True`: K1, K2, K4 and K5 store f32 there too, and the
    losses agree within 1e-6 relative."""
    got, want, outputs = _losses_both(rng, 64, 192, dict(pallas_bf16_out=True, **flags))
    assert outputs[("rgb", -1, 0)].dtype == torch.float32
    for k in want:
        assert _rel(got[k], want[k]) < 1e-6, k


def test_k2_and_k3_wrappers_check_inputs(rng):
    """The wrappers check types and shapes before any launch; outside
    autograd they run the forward alone."""
    src, coords, g = _warp_inputs(rng, 1, 16, 32, 1.0, edges=False)
    s, c, gt = (torch.from_numpy(x) for x in (src, coords, g))
    assert torch.equal(wp.warp_two_kernel(s, c), wp.warp_dynamic(s, c))
    assert torch.equal(wp.warp_two_kernel(s, c), wp.warp_static(s, c))
    with pytest.raises(TypeError):
        wp.warp_two_kernel(s.double(), c)
    with pytest.raises(ValueError):
        wp.warp_static_bwd(s, c, gt[..., :2])
    with pytest.raises(ValueError):
        wp.warp_static_bwd(s, c[:, :-1], gt)
    with pytest.raises(ValueError):  # truncated taps are stored as f32 only
        wp.warp_static(s, c, True, True)


@pytest.mark.gpu
def test_k2_kernels_match_plain_on_gpu(rng):
    """The CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the warp kernels have no CPU build")
    src, coords, g = _warp_inputs(rng, 2, 24, 384, 20.0, edges=True)
    s, c, gt = (torch.from_numpy(x).cuda() for x in (src, coords, g))
    for trunc in (False, True):
        torch.testing.assert_close(wp.warp_static(s, c, False, trunc),
                                   wp.warp_two_kernel_plain(s, c, trunc), atol=1e-6, rtol=0)
        torch.testing.assert_close(wp.warp_static_bwd(s, c, gt, trunc),
                                   wp.warp_grad_plain(s, c, gt, trunc), atol=1e-5, rtol=1e-5)
