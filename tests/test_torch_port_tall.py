"""Kernels K4 and K5 of the PyTorch port (`tpuslam_torch.ops.warp`:
`warp_tall`, `warp_tall_proj`) and `projection_affine` against the JAX
package.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode (`pallas_warp_tall`,
`pallas_warp_tall_proj`) where the flow stays within the TPU kernels' 128 px
horizontal window, and its XLA sampler `bilinear_sampler` where the flow
leaves it.  The same numpy inputs go to both.  The kernels themselves are
held against the plain versions on the card by the GPU-marked test here and
by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuslam.geometry.camera import bilinear_sampler
from tpuslam.geometry.camera import projection_affine as jax_projection_affine
from tpuslam.geometry.se3 import transformation_from_parameters
from tpuslam.ops.pallas_warp import pallas_warp_tall, pallas_warp_tall_proj, proj_coords_xla
from tpuslam_torch.geometry.camera import projection_affine
from tpuslam_torch.ops import warp as wp

torch.set_num_threads(1)

B, S, H, W, C = 2, 2, 32, 384, 3
N = 2 * S * B


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _max_bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of `want`, |want| counted as at
    least 2^-10 (below that the f32 rounding of the taps exceeds an ulp)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -10))) - 7)
    return float((np.abs(got - want) / ulp).max())


def _src2(rng, B=B, H=H, W=W, C=C):
    return rng.uniform(size=(2 * B, H, W, C)).astype(np.float32)


def _coords(rng, shift, N=N, H=H, W=W):
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    out = []
    for k in range(N):
        dx = shift * np.sin(gy / H * (2 + k)) + rng.uniform(-1, 1, (H, W))
        dy = 6.0 * np.cos(gx / W * (1 + 0.3 * k)) + rng.uniform(-1, 1, (H, W))
        out.append(np.stack([gx + dx, gy + dy], axis=-1))
    return np.stack(out).astype(np.float32)


def _proj_inputs(rng, tr_scale=0.05, S=S, B=B, H=H, W=W):
    """depth (S*B, H, W, 1), K, inv_K (2B, 4, 4), T (2B, 4, 4) as numpy."""
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    depth = np.stack([4.0 + 1.5 * np.sin(gx / W * (2 + k)) * np.cos(gy / H * (1 + k))
                      for k in range(S * B)])[..., None].astype(np.float32)
    K = np.tile(np.eye(4, dtype=np.float32), (2 * B, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    aa = (0.01 * rng.normal(size=(2 * B, 3))).astype(np.float32)
    tr = (tr_scale * rng.normal(size=(2 * B, 3))).astype(np.float32)
    T = np.array(transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr)))
    return depth, K, np.linalg.inv(K).astype(np.float32), T


def _jax_vjp(fn, args, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    grads = vjp(jnp.asarray(g).astype(out.dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(x) for x in grads]


def _port_vjp(fn, args, g):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = fn(*ts)
    (out.float() * torch.from_numpy(g)).sum().backward()
    grads = [None if t.grad is None else t.grad.numpy() for t in ts]
    return out.float().detach().numpy(), grads, out.dtype


def test_projection_affine_and_proj_coords_match_jax(rng):
    """The affine camera maps and the coordinates K5 computes from them,
    within 1e-6 relative of the JAX package's."""
    depth, K, inv_K, T = _proj_inputs(rng)
    want_ab = np.array(jax_projection_affine(jnp.asarray(K), jnp.asarray(inv_K), jnp.asarray(T)))
    ab = projection_affine(*(torch.from_numpy(a) for a in (K, inv_K, T)))
    assert _rel(ab, want_ab) < 1e-6
    want = np.asarray(proj_coords_xla(jnp.asarray(depth), jnp.asarray(want_ab), S))
    got = wp.proj_coords_plain(torch.from_numpy(depth), torch.from_numpy(want_ab), S)
    assert got.shape == (N, H, W, 2)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("bf16_out", [False, True])
def test_warp_tall_matches_pallas_kernel_in_window(rng, bf16_out):
    """K4 inside the TPU window: values and dcoords against the Pallas
    kernel (interpret mode) and its fused VJP, within 1e-5 in f32; bf16
    stores within one bf16 ulp."""
    src2, coords = _src2(rng), _coords(rng, 2.5)
    g = rng.normal(size=(N, H, W, C)).astype(np.float32)
    want, (_, gwant) = _jax_vjp(
        lambda s, c: pallas_warp_tall(s, c, True, S, bf16_out), (src2, coords), g)
    got, (_, ggot), dtype = _port_vjp(
        lambda s, c: wp.warp_tall(s, c, S, bf16_out), (src2, coords), g)
    assert dtype == (torch.bfloat16 if bf16_out else torch.float32)
    if bf16_out:
        assert _max_bf16_ulps(got, want) <= 1.0
        np.testing.assert_allclose(ggot, gwant, atol=4e-3, rtol=4e-3)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(ggot, gwant, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bf16_out", [False, True])
def test_warp_tall_proj_matches_pallas_kernel_in_window(rng, bf16_out):
    """K5 inside the TPU window, values and the gradients to depth and ab.

    The port's projection equals `proj_coords_xla` bit for bit, and the JAX
    package states that its in-kernel projection matches the tall kernel at
    those coordinates only to FMA contraction (~1e-4 px,
    `test_pallas_fused.py`).  So the port is held within 1e-5 against the
    Pallas tall kernel (interpret mode) at `proj_coords_xla` and its fused
    VJP chained through XLA autodiff (gradients in norm: the chain's
    divisions round differently), and against `pallas_warp_tall_proj`
    itself within that package's own 3e-4; bf16 stores within one bf16
    ulp."""
    src2 = _src2(rng)
    depth, K, inv_K, T = _proj_inputs(rng)
    ab = np.asarray(jax_projection_affine(jnp.asarray(K), jnp.asarray(inv_K), jnp.asarray(T)))
    g = rng.normal(size=(N, H, W, C)).astype(np.float32)
    want, (gd_want, gab_want) = _jax_vjp(
        lambda d, a: pallas_warp_tall(jnp.asarray(src2), proj_coords_xla(d, a, S), True, S,
                                      bf16_out), (depth, ab), g)
    got, (gd, gab), _ = _port_vjp(
        lambda d, a: wp.warp_tall_proj(torch.from_numpy(src2), d, a, S, bf16_out),
        (depth, ab), g)
    if bf16_out:
        assert _max_bf16_ulps(got, want) <= 1.0
        assert _rel(gd, gd_want) < 4e-3 and _rel(gab, gab_want) < 4e-3
        return
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert _rel(gd, gd_want) < 1e-5 and _rel(gab, gab_want) < 1e-5
    in_kernel = np.asarray(pallas_warp_tall_proj(jnp.asarray(src2), jnp.asarray(depth),
                                                 jnp.asarray(ab), True, S))
    np.testing.assert_allclose(got, in_kernel, atol=3e-4)


@pytest.mark.parametrize("proj", [False, True])
def test_tall_warps_match_sampler_beyond_window(rng, proj):
    """Flow beyond the TPU window (where the Pallas kernels clamp) and
    exact-edge ties: the port is exact like the XLA sampler on the tiled
    sources, with its 0.5 edge subgradient and zero gradient outside."""
    src2 = _src2(rng)
    g = rng.normal(size=(N, H, W, C)).astype(np.float32)
    tiled = jnp.asarray(np.asarray(wp.tall_sources(torch.from_numpy(src2), S)))
    if proj:
        # a 1.5 m sideways step moves near pixels by ~100-250 px
        depth, K, inv_K, T = _proj_inputs(rng)
        T[:, 0, 3] = 1.5
        depth[:, :, :40] = 0.5  # nearer: beyond 128 px, and off the image
        ab = np.asarray(jax_projection_affine(jnp.asarray(K), jnp.asarray(inv_K),
                                              jnp.asarray(T)))
        want, (gd_want, gab_want) = _jax_vjp(
            lambda d, a: bilinear_sampler(tiled, proj_coords_xla(d, a, S)), (depth, ab), g)
        got, (gd, gab), _ = _port_vjp(
            lambda d, a: wp.warp_tall_proj(torch.from_numpy(src2), d, a, S), (depth, ab), g)
        flow = np.asarray(proj_coords_xla(jnp.asarray(depth), jnp.asarray(ab), S))[..., 0]
        assert np.abs(flow - np.arange(W)).max() > 200
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert _rel(gd, gd_want) < 1e-5 and _rel(gab, gab_want) < 1e-5
        return
    coords = _coords(rng, 200.0)
    coords[:, :, :4, 0] = -2.0  # outside: zero gradient
    coords[:, :, 4, 0] = 0.0  # exact left edge: 0.5
    coords[:, 5, :, 1] = H - 1.0  # exact bottom edge: 0.5
    coords[:, 7, :, 1] = H + 30.0  # far outside
    want, (gwant,) = _jax_vjp(lambda c: bilinear_sampler(tiled, c), (coords,), g)
    got, (ggot,), _ = _port_vjp(lambda c: wp.warp_tall(torch.from_numpy(src2), c, S),
                                (coords,), g)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(ggot, gwant, atol=1e-5, rtol=1e-5)
    assert np.all(ggot[:, :, :4, 0] == 0.0) and np.all(ggot[:, 7, :, 1] == 0.0)


@pytest.mark.parametrize("proj", [False, True], ids=["K4", "K5"])
@pytest.mark.parametrize("shape", [(3, 1, 50, 130, 3), (2, 1, 2, 70, 3), (1, 2, 37, 2, 3),
                                   (2, 1, 40, 70, 4), (2, 1, 40, 70, 1)],
                         ids=["50x130", "2x70", "37x2", "C4", "C1"])
def test_tall_warps_match_sampler_at_ragged_shapes(rng, shape, proj):
    """(S, B, H, W, C) that no run of columns or 16-byte vector of the kernel
    divides, H = 2, W = 2, C = 4 and C = 1: the port's K4 and K5 routes (their
    plain versions here, the kernel's oracle on the card at the same shapes)
    against the XLA sampler on the tiled sources, at `proj_coords_xla` for
    K5: values within 1e-5, dcoords within 1e-5, d depth and d ab within
    1e-5 relative."""
    s, b, h, w, c = shape
    n = 2 * s * b
    src2 = _src2(rng, b, h, w, c)
    g = rng.normal(size=(n, h, w, c)).astype(np.float32)
    tiled = jnp.asarray(np.asarray(wp.tall_sources(torch.from_numpy(src2), s)))
    if proj:
        depth, K, inv_K, T = _proj_inputs(rng, 0.05, s, b, h, w)
        depth[:, :, :2] = 0.3  # near: projects off the image
        ab = np.asarray(jax_projection_affine(jnp.asarray(K), jnp.asarray(inv_K),
                                              jnp.asarray(T)))
        want, (gd_want, gab_want) = _jax_vjp(
            lambda d, a: bilinear_sampler(tiled, proj_coords_xla(d, a, s)), (depth, ab), g)
        got, (gd, gab), _ = _port_vjp(
            lambda d, a: wp.warp_tall_proj(torch.from_numpy(src2), d, a, s), (depth, ab), g)
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert _rel(gd, gd_want) < 1e-5 and _rel(gab, gab_want) < 1e-5
        return
    coords = _coords(rng, 4.0, n, h, w)
    coords[:, :, :2, 0] = -2.0  # outside: zero gradient
    coords[:, 0, :, 1] = 0.0  # exact top edge
    coords[:, :, -1, 0] = w - 1.0  # exact right edge
    coords[:, h // 2] = np.floor(coords[:, h // 2])  # integer coordinates
    want, (gwant,) = _jax_vjp(lambda c: bilinear_sampler(tiled, c), (coords,), g)
    got, (ggot,), _ = _port_vjp(lambda c: wp.warp_tall(torch.from_numpy(src2), c, s),
                                (coords,), g)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(ggot, gwant, atol=1e-5, rtol=1e-5)


def test_tall_warps_without_grad_take_no_taps(rng):
    """Outside autograd the tall warps run without taps, with bf16 storage
    when asked, and equal the warp with taps; bad shapes and types raise
    before any launch."""
    src2, coords = torch.from_numpy(_src2(rng)), torch.from_numpy(_coords(rng, 2.5))
    depth, K, inv_K, T = _proj_inputs(rng)
    ab = projection_affine(*(torch.from_numpy(a) for a in (K, inv_K, T)))
    depth = torch.from_numpy(depth)
    out = wp.warp_tall(src2, coords, S, True)
    assert out.dtype == torch.bfloat16 and out.shape == (N, H, W, C)
    assert torch.equal(out, wp.warp_tall_taps(src2, coords, S, True)[0])
    out = wp.warp_tall_proj(src2, depth, ab, S, False)
    assert torch.equal(out, wp.warp_tall_proj_taps(src2, depth, ab, S, False)[0])
    with pytest.raises(ValueError):
        wp.warp_tall(src2, coords[:-1], S)
    with pytest.raises(ValueError):
        wp.warp_tall(src2[:-1], coords[:-S], S)
    with pytest.raises(ValueError):
        wp.warp_tall_proj(src2, depth[:-1], ab, S)
    with pytest.raises(TypeError):
        wp.warp_tall_proj(src2, depth.double(), ab, S)


@pytest.mark.gpu
def test_tall_kernels_match_plain_on_gpu(rng):
    """K4 and K5, with and without taps, against their plain versions on
    the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the warp kernel has no CPU build")
    src2 = torch.from_numpy(_src2(rng)).cuda()
    coords = torch.from_numpy(_coords(rng, 20.0)).cuda()
    depth, K, inv_K, T = _proj_inputs(rng)
    ab = projection_affine(*(torch.from_numpy(a) for a in (K, inv_K, T))).cuda()
    depth = torch.from_numpy(depth).cuda()
    for got, want in ((wp.warp_tall_taps(src2, coords, S), wp.warp_tall_plain(src2, coords, S)),
                      (wp.warp_tall_proj_taps(src2, depth, ab, S),
                       wp.warp_tall_proj_plain(src2, depth, ab, S))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(wp.warp_tall_notaps(src2, coords, S),
                               wp.warp_tall_plain(src2, coords, S)[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(wp.warp_tall_proj_notaps(src2, depth, ab, S),
                               wp.warp_tall_proj_plain(src2, depth, ab, S)[0], atol=1e-5, rtol=0)
