"""Kernel K1 of the PyTorch port (`tpuslam_torch.ops.warp`) against the JAX
package's warp.

On the CPU the port's wrapper runs its plain version; the JAX side runs its
Pallas kernel in interpret mode (`pallas_warp_static_fused(..., interpret=
True)`) where the flow stays inside the TPU kernel's window, and its XLA
sampler `bilinear_sampler` where the flow leaves it (large flows, exact-edge
ties).  The same numpy inputs go to both.  The kernel itself is held
against the plain version on the card by `test_kernel_matches_plain_on_gpu`
and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuslam.geometry.camera import bilinear_sampler
from tpuslam.ops.pallas_warp import pallas_warp_static_fused
from tpuslam_torch.ops import warp as wp

torch.set_num_threads(1)

B, H, W, C = 2, 48, 384, 3


def _inputs(rng, max_shift=3.0):
    src = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    dx = max_shift * np.sin(gy / H * 3.0) + rng.uniform(-1, 1, (B, H, W))
    dy = max_shift * np.cos(gx / W * 2.0) + rng.uniform(-1, 1, (B, H, W))
    coords = np.stack([gx + dx, gy + dy], axis=-1).astype(np.float32)
    return src, coords


def _port(src, coords, bf16_out):
    """Port warp value and d(sum(out * g))/d(coords) via torch autograd."""
    c = torch.from_numpy(coords).requires_grad_()
    out = wp.warp(torch.from_numpy(src), c, bf16_out)
    g = torch.from_numpy(np.linspace(-1, 1, out.numel(), dtype=np.float32)).reshape(out.shape)
    (out.float() * g).sum().backward()
    return out.float().detach().numpy(), c.grad.numpy(), g.numpy()


def _jax_grad(fn, coords, g):
    return np.asarray(jax.grad(lambda c: (fn(c).astype(jnp.float32) * g).sum())(
        jnp.asarray(coords)))


@pytest.mark.parametrize("bf16_out,tol", [(False, 1e-5), (True, 4e-3)])
def test_warp_matches_pallas_kernel_in_window(rng, bf16_out, tol):
    """Flow inside the TPU window (extra_tiles=2): value and dcoords match
    the Pallas kernel (interpret mode) and its fused VJP."""
    src, coords = _inputs(rng)
    out, grad, g = _port(src, coords, bf16_out)

    def ref(c):
        return pallas_warp_static_fused(jnp.asarray(src), c, True, 2, True, bf16_out)

    want = np.asarray(ref(jnp.asarray(coords)), np.float32)
    np.testing.assert_allclose(out, want, atol=tol)
    np.testing.assert_allclose(grad, _jax_grad(ref, coords, g), atol=tol, rtol=tol)


def test_warp_matches_sampler_beyond_window_and_at_edges(rng):
    """Large flows (beyond the TPU window, where the Pallas kernel clamps)
    and exact-edge ties: the port is exact like the XLA sampler, including
    its 0.5 edge subgradient and zero gradient outside the image."""
    src, coords = _inputs(rng, max_shift=40.0)
    coords[:, :, :4, 0] = -2.0  # outside: zero gradient
    coords[:, :, 4, 0] = 0.0  # exact left edge: 0.5
    coords[:, 5, :, 1] = H - 1.0  # exact bottom edge: 0.5
    coords[:, 7, :, 1] = H + 30.0  # far outside
    out, grad, g = _port(src, coords, False)

    def ref(c):
        return bilinear_sampler(jnp.asarray(src), c)

    np.testing.assert_allclose(out, np.asarray(ref(jnp.asarray(coords))), atol=1e-5)
    want = _jax_grad(ref, coords, g)
    np.testing.assert_allclose(grad, want, atol=1e-5, rtol=1e-5)
    assert np.all(grad[:, :, :4, 0] == 0.0) and np.all(grad[:, 7, :, 1] == 0.0)
    # the edge columns carry half of the interior subgradient
    full = wp.warp_static_fused_plain(torch.from_numpy(src), torch.from_numpy(coords))[1]
    edge = (g[:, :, 4] * full[:, :, 4].numpy()).sum(-1)
    np.testing.assert_allclose(grad[:, :, 4, 0], 0.5 * edge, atol=1e-5)


def _ragged_inputs(rng, n, h, w, c):
    """Smooth flow with points off the image, exact-edge ties and integer
    coordinates, at (n, h, w, c)."""
    src = rng.uniform(size=(n, h, w, c)).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    dx = 4.0 * np.sin(gy / h * 3.0) + rng.uniform(-1, 1, (n, h, w))
    dy = 3.0 * np.cos(gx / w * 2.0) + rng.uniform(-1, 1, (n, h, w))
    coords = np.stack([gx + dx, gy + dy], axis=-1).astype(np.float32)
    coords[:, :, :2, 0] = -2.0  # outside: zero gradient
    coords[:, 0, :, 1] = 0.0  # exact top edge
    coords[:, :, -1, 0] = w - 1.0  # exact right edge
    coords[:, h // 2] = np.floor(coords[:, h // 2])  # integer coordinates
    return src, coords


@pytest.mark.parametrize("shape", [(3, 50, 130, 3), (2, 2, 70, 3), (3, 37, 2, 3),
                                   (2, 40, 70, 4), (2, 40, 70, 1)],
                         ids=["50x130", "2x70", "37x2", "C4", "C1"])
def test_warp_matches_sampler_at_ragged_shapes(rng, shape):
    """Shapes that no run of columns or 16-byte vector of the kernel divides,
    H = 2, W = 2, C = 4 and C = 1: the port's K1 route (its plain version
    here, the kernel's oracle on the card at the same shapes) against the
    XLA sampler, value and dcoords within 1e-5."""
    src, coords = _ragged_inputs(rng, *shape)
    out, grad, g = _port(src, coords, False)

    def ref(c):
        return bilinear_sampler(jnp.asarray(src), c)

    np.testing.assert_allclose(out, np.asarray(ref(jnp.asarray(coords))), atol=1e-5)
    np.testing.assert_allclose(grad, _jax_grad(ref, coords, g), atol=1e-5, rtol=1e-5)


def test_warp_without_grad_takes_no_taps(rng):
    """Outside autograd the wrapper runs K1 without taps, with bf16 storage
    when asked; it checks types and shapes before any launch."""
    src, coords = _inputs(rng)
    s, c = torch.from_numpy(src), torch.from_numpy(coords)
    out = wp.warp(s, c, True)
    assert out.dtype == torch.bfloat16
    with_taps = wp.warp_static_fused(s, c, True)
    assert all(t.dtype == torch.bfloat16 for t in with_taps)
    assert torch.equal(out, with_taps[0])
    with pytest.raises(TypeError):
        wp.warp(s.double(), c)
    with pytest.raises(ValueError):
        wp.warp(s, c[:, :-1])


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(rng):
    """The CUDA kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the warp kernel has no CPU build")
    src, coords = _inputs(rng, max_shift=20.0)
    s, c = torch.from_numpy(src).cuda(), torch.from_numpy(coords).cuda()
    got = wp.warp_static_fused(s, c, False)
    want = wp.warp_static_fused_plain(s, c)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(wp.warp_static(s, c, False), want[0], atol=1e-5, rtol=0)
