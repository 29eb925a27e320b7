"""Kernels K6, K6' and K7/K8 of the PyTorch port (`tpuslam_torch.ops.reproj`)
against the JAX package.

On the CPU the port's wrappers run their plain versions (`reprojection_loss`
and its torch autograd); the JAX side runs its Pallas kernels in interpret
mode: `pallas_reproj_err` (K6 forward, K6' backward) and the composites
`warp_reproj_err` / `warp_reproj_err_proj` (K4 or K5, K6, and the fused K7 /
K8 backward).  The same numpy inputs go to both.  The kernels themselves are
held against the plain versions on the card by the GPU-marked test here and
by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuslam.geometry.camera import projection_affine as jax_projection_affine
from tpuslam.geometry.se3 import transformation_from_parameters
from tpuslam.ops.pallas_fused import warp_reproj_err as jax_warp_reproj_err
from tpuslam.ops.pallas_fused import warp_reproj_err_proj as jax_warp_reproj_err_proj
from tpuslam.ops.pallas_loss import pallas_reproj_err
from tpuslam.ops.pallas_warp import proj_coords_xla
from tpuslam_torch.losses.photometric import reprojection_loss
from tpuslam_torch.ops import reproj as rp

torch.set_num_threads(1)

B, S, H, W, C = 2, 2, 32, 384, 3
N = 2 * S * B


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _max_bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of `want` (|want| >= 2^-10)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -10))) - 7)
    return float((np.abs(got - want) / ulp).max())


def _preds_target(rng, n=N):
    """Random preds and targets with the cases the kernels must get right:
    a region where pred equals its target exactly (|y - x| = 0, SSIM = 1 on
    the clamp's edge), constant patches, and the reflected border rows and
    columns (every pixel of rows/columns 0, 1, H-2, H-1 is compared)."""
    target = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    preds = rng.uniform(size=(n, H, W, C)).astype(np.float32)
    preds[0, :12, :40] = target[0, :12, :40]  # exact ties, touching row 0 and column 0
    preds[1, -10:, -30:] = target[1, -10:, -30:]  # and the last row and column
    preds[-1, 10:20, 100:140] = 0.25  # constant pred patch
    target[0, 10:20, 200:240] = 0.75  # constant target patch
    preds[0, 10:20, 200:240] = 0.75  # constant and equal
    return preds, target


def _port_err_vjp(preds, target, g):
    p = torch.from_numpy(preds).requires_grad_()
    err = rp.reproj_err(p, torch.from_numpy(target))
    (err * torch.from_numpy(g)).sum().backward()
    return err.detach().numpy(), p.grad


def _jax_err_vjp(preds, target, g):
    err, vjp = jax.vjp(lambda p: pallas_reproj_err(p, jnp.asarray(target), True),
                       jnp.asarray(preds))
    return np.asarray(err), vjp(jnp.asarray(g))[0]


@pytest.mark.parametrize("bf16", [False, True])
def test_reproj_err_matches_pallas_kernel(rng, bf16):
    """K6 within 1e-5 absolute of `pallas_reproj_err` (interpret mode); K6'
    d err / d pred within 1e-5 relative of its VJP, cast to the preds'
    dtype like it (bf16 preds: within one bf16 ulp)."""
    preds, target = _preds_target(rng)
    g = rng.normal(size=(N, H, W)).astype(np.float32)
    if bf16:
        preds = np.array(jnp.asarray(preds).astype(jnp.bfloat16).astype(jnp.float32))
    want, dwant = _jax_err_vjp(jnp.asarray(preds).astype(jnp.bfloat16) if bf16 else preds,
                               target, g)
    p = torch.from_numpy(preds).to(torch.bfloat16 if bf16 else torch.float32)
    p.requires_grad_()
    err = rp.reproj_err(p, torch.from_numpy(target))
    (err * torch.from_numpy(g)).sum().backward()
    assert err.dtype == torch.float32 and err.shape == (N, H, W)
    np.testing.assert_allclose(err.detach().numpy(), want, atol=1e-5)
    assert p.grad.dtype == p.dtype and dwant.dtype == (jnp.bfloat16 if bf16 else jnp.float32)
    dgot, dwant = p.grad.float().numpy(), np.asarray(dwant.astype(jnp.float32))
    if bf16:
        assert _max_bf16_ulps(dgot, dwant) <= 1.0
    else:
        assert _rel(dgot, dwant) < 1e-5


def test_reproj_err_at_reflected_borders_and_exact_ties(rng):
    """Explicitly: rows and columns 0, 1, H-2 and H-1, where the reflected
    pools count pixel 1 (H-2) twice, against the JAX kernel; and where pred
    equals target over a whole 3x3 window, the error is 0 and the gradient
    is the L1 term's subgradient at a tie alone, -0.15 / C * g (jnp.abs's
    +1 at 0; torch.abs would give 0)."""
    preds, target = _preds_target(rng, n=B)
    g = rng.normal(size=(B, H, W)).astype(np.float32)
    got, dgot = _port_err_vjp(preds, target, g)
    want, dwant = _jax_err_vjp(preds, target, g)
    dgot, dwant = dgot.numpy(), np.asarray(dwant)
    for idx in (0, 1, H - 2, H - 1):
        np.testing.assert_allclose(got[:, idx], want[:, idx], atol=1e-5)
        assert _rel(dgot[:, idx], dwant[:, idx]) < 1e-5, f"row {idx}"
    for idx in (0, 1, W - 2, W - 1):
        np.testing.assert_allclose(got[:, :, idx], want[:, :, idx], atol=1e-5)
        assert _rel(dgot[:, :, idx], dwant[:, :, idx]) < 1e-5, f"column {idx}"
    # a window holding only exact ties (pred 0, rows 0-10, columns 0-38,
    # reflected at row 0 and column 0): error and gradient vanish (the JAX
    # kernel sums its pools in another order and leaves ~1e-8 of SSIM)
    assert np.all(got[0, :10, :38] == 0.0) and np.abs(want[0, :10, :38]).max() < 1e-7
    l1_only = np.broadcast_to(-0.15 / C * g[0, :9, :37, None], (9, 37, C))
    np.testing.assert_allclose(dgot[0, :9, :37], l1_only, atol=1e-6)
    np.testing.assert_allclose(dwant[0, :9, :37], l1_only, atol=1e-6)


def _reflect_multiplicity(n):
    """M[r, q]: how often pixel q sits in the reflected 3-window of error
    pixel r (row -1 is row 1, row n is row n-2)."""
    m = np.zeros((n, n))
    for r in range(n):
        for k in (r - 1, r, r + 1):
            m[r, -k if k < 0 else (2 * n - 2 - k if k >= n else k)] += 1
    return torch.from_numpy(m)


def _err_bwd_two_stages(x, y, g):
    """d err / d pred as the error-map kernels compute it, in float64: first
    each error pixel r's pool-adjoint coefficients (d err_r / d(mx, P(xx),
    P(xy)) times g_r / C, gated by the clamp's `live`), then for each pred
    pixel q the sum over its 3x3 neighbours r of w_rq / 9 (cm_r + 2 x_q
    cxx_r + y_q cxy_r), plus the L1 term with sign(0) = +1."""
    C = x.shape[-1]

    def pool(a):  # reflect-padded 3x3 mean, rows then columns
        a = torch.cat([a[:, 1:2], a, a[:, -2:-1]], 1)
        a = torch.cat([a[:, :, 1:2], a, a[:, :, -2:-1]], 2)
        a = (a[:, :-2] + a[:, 1:-1] + a[:, 2:]) / 3
        return (a[:, :, :-2] + a[:, :, 1:-1] + a[:, :, 2:]) / 3

    mx, my, pxx, pyy, pxy = pool(x), pool(y), pool(x * x), pool(y * y), pool(x * y)
    n1, n2 = 2 * mx * my + 1e-4, 2 * (pxy - mx * my) + 9e-4
    d1, d2 = mx * mx + my * my + 1e-4, (pxx - mx * mx) + (pyy - my * my) + 9e-4
    num, den = n1 * n2, d1 * d2
    s = (1 - num / den) / 2
    live = torch.where((s > 0) & (s < 1), 1.0, torch.where((s == 0) | (s == 1), 0.5, 0.0)).double()
    k = 0.85 * live * g[..., None] / C * 0.5 / den
    dn1, dn2, dd1, dd2 = -k * n2, -k * n1, k * num / den * d2, k * num / den * d1
    cm, cxx, cxy = 2 * (my * (dn1 - dn2) + mx * (dd1 - dd2)), dd2, 2 * dn2
    mh, mw = _reflect_multiplicity(x.shape[1]), _reflect_multiplicity(x.shape[2])

    def gather(coef):
        return torch.einsum("rq,sp,nrsc->nqpc", mh, mw, coef) / 9

    l1 = -0.15 * torch.where(y - x >= 0, 1.0, -1.0).double() / C * g[..., None]
    return gather(cm) + 2 * x * gather(cxx) + y * gather(cxy) + l1, s


def test_backward_decomposition_matches_autograd(rng):
    """The error-map kernels' backward in two stages (per-error-pixel
    coefficients, then the 3x3 gather with the reflect multiplicities w_rq)
    against autograd of the plain version's function (`reproj_err_plain` is
    `reprojection_loss` against target n % B, here in float64) within 1e-10,
    at an 11 x 13 size where most pixels touch a reflected border, with
    exact ties (SSIM on the clamp's edge) and pixels where rounding puts SSIM
    past the clamp."""
    n, b, h, w = 4, 2, 11, 13
    target = rng.uniform(size=(b, h, w, C))
    preds = rng.uniform(size=(n, h, w, C))
    preds[0, :5, :6] = target[0, :5, :6]  # exact ties, touching row 0 and column 0
    preds[1, 4:, 7:] = target[1, 4:, 7:]  # and the last row and column
    preds[2] = target[0] * (1 + 2.0 ** -30)  # SSIM rounds to either side of 1
    g = torch.from_numpy(rng.normal(size=(n, h, w)))
    x, y = torch.from_numpy(preds), rp._targets(torch.from_numpy(target), n)
    got, s = _err_bwd_two_stages(x, y, g)
    assert (s < 0).any() and (s == 0).any() and (s > 0).any()  # clamped, on the edge, live
    p = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(reprojection_loss(p, y), p, g)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def _coords(rng):
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    return np.stack([np.stack([gx + 2.5 * np.sin(gy / H * (2 + k)),
                               gy + 6.0 * np.cos(gx / W * (1 + 0.3 * k))], axis=-1)
                     for k in range(N)]).astype(np.float32)


def _proj_inputs(rng):
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    depth = np.stack([4.0 + 1.5 * np.sin(gx / W * (2 + k)) * np.cos(gy / H * (1 + k))
                      for k in range(S * B)])[..., None].astype(np.float32)
    K = np.tile(np.eye(4, dtype=np.float32), (2 * B, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    T = transformation_from_parameters(
        jnp.asarray(0.01 * rng.normal(size=(2 * B, 3)), jnp.float32),
        jnp.asarray(0.05 * rng.normal(size=(2 * B, 3)), jnp.float32))
    ab = jax_projection_affine(jnp.asarray(K), jnp.asarray(np.linalg.inv(K)), T)
    return depth, np.asarray(ab)


@pytest.mark.parametrize("proj", [False, True])
def test_composites_match_jax(rng, proj):
    """`warp_reproj_err` (K4, K6, K7) and `warp_reproj_err_proj` (K5, K6,
    K8): error maps and warped stack within 1e-5, the gradient that reaches
    coords (or depth and ab) through the error maps within 1e-5 relative,
    and the warped stack detached.  The proj composite is held against the
    JAX composite at `proj_coords_xla`, which the port's projection equals
    bit for bit (see test_torch_port_tall.py), and against the JAX proj
    composite within that package's own 3e-4 for its in-kernel projection."""
    src2 = rng.uniform(size=(2 * B, H, W, C)).astype(np.float32)
    target = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    g = rng.uniform(size=(N, H, W)).astype(np.float32)
    js, jt = jnp.asarray(src2), jnp.asarray(target)
    ts, tt = torch.from_numpy(src2), torch.from_numpy(target)
    if proj:
        args = _proj_inputs(rng)

        def jfn(d, a):
            return jax_warp_reproj_err(js, proj_coords_xla(d, a, S), jt, True, S)

        def tfn(d, a):
            return rp.warp_reproj_err_proj(ts, d, a, tt, S)
    else:
        args = (_coords(rng),)

        def jfn(c):
            return jax_warp_reproj_err(js, c, jt, True, S)

        def tfn(c):
            return rp.warp_reproj_err(ts, c, tt, S)

    (want, warped_want), vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    gwant = vjp((jnp.asarray(g), jnp.zeros_like(warped_want)))
    targs = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    err, warped = tfn(*targs)
    assert err.requires_grad and not warped.requires_grad
    (err * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(err.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(warped.numpy(), np.asarray(warped_want), atol=1e-5)
    for t, w in zip(targs, gwant):
        assert _rel(t.grad, w) < 1e-5
    if proj:
        in_kernel, _ = jax_warp_reproj_err_proj(js, *[jnp.asarray(a) for a in args], jt, True, S)
        np.testing.assert_allclose(err.detach().numpy(), np.asarray(in_kernel), atol=3e-4)


def test_wrappers_check_their_inputs(rng):
    """Shapes and types are checked before any launch; off autograd the
    composites run the warp without taps and K6 only."""
    preds, target = (torch.from_numpy(a) for a in _preds_target(rng))
    with pytest.raises(ValueError):
        rp.reproj_err(preds[:3], target)  # N not a multiple of B
    with pytest.raises(TypeError):
        rp.reproj_err(preds.double(), target)
    with pytest.raises(ValueError):
        rp.reproj_err_bwd(preds, target, torch.zeros(N, H, W - 1))
    src2 = torch.from_numpy(rng.uniform(size=(2 * B, H, W, C)).astype(np.float32))
    coords = torch.from_numpy(_coords(rng))
    err, warped = rp.warp_reproj_err(src2, coords, target, S, True)
    assert warped.dtype == torch.bfloat16 and not err.requires_grad
    torch.testing.assert_close(err, rp.reproj_err_plain(warped, target), rtol=0, atol=0)


@pytest.mark.gpu
def test_error_map_kernels_match_plain_on_gpu(rng):
    """K6, K6' and K7/K8 against their plain versions on the card, f32 and
    bf16 preds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the error-map kernels have no CPU build")
    preds, target = (torch.from_numpy(a).cuda() for a in _preds_target(rng))
    g = torch.from_numpy(rng.normal(size=(N, H, W)).astype(np.float32)).cuda()
    taps = [torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32)).cuda()
            for _ in range(2)]
    for dtype in (torch.float32, torch.bfloat16):
        p = preds.to(dtype)
        dx, dy = (t.to(dtype) for t in taps)
        torch.testing.assert_close(rp.reproj_err_fwd(p, target), rp.reproj_err_plain(p, target),
                                   atol=1e-5, rtol=0)
        want = rp.reproj_err_bwd_plain(p, target, g)
        got = rp.reproj_err_bwd(p, target, g)
        assert got.dtype == dtype
        if dtype == torch.float32:
            assert float((got - want).norm() / want.norm()) < 1e-5
        else:
            assert _max_bf16_ulps(got.float().cpu(), want.to(dtype).float().cpu()) <= 1.0
        want = rp.err_bwd_coords_plain(p, target, g, dx, dy)
        got = rp.err_bwd_coords(p, target, g, dx, dy)
        assert float((got - want).norm() / want.norm()) < 1e-5
