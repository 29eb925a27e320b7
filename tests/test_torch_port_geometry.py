"""Geometry and losses of the PyTorch port against the JAX package.

The same numpy inputs go through each JAX function and its port; values and
gradients agree within 1e-5 relative (float32 sums taken in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuslam.geometry import camera as jcam
from tpuslam.geometry import depth as jdepth
from tpuslam.geometry import se3 as jse3
from tpuslam.losses import photometric as jloss
from tpuslam_torch.geometry import camera as tcam
from tpuslam_torch.geometry import depth as tdepth
from tpuslam_torch.geometry import se3 as tse3
from tpuslam_torch.losses import photometric as tloss

torch.set_num_threads(1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(rng, invert):
    aa = rng.normal(scale=0.3, size=(5, 3)).astype(np.float32)
    aa[0] = 0.0  # identity rotation: the safe-norm branch
    tr = rng.normal(size=(5, 3)).astype(np.float32)
    w = rng.normal(size=(5, 4, 4)).astype(np.float32)

    def jfn(a, t):
        return (jse3.transformation_from_parameters(a, t, invert) * w).sum()

    want = jse3.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr), invert)
    jga, jgt = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(aa), jnp.asarray(tr))
    ta, tt = _t(aa, True), _t(tr, True)
    got = tse3.transformation_from_parameters(ta, tt, invert)
    (got * _t(w)).sum().backward()
    assert _rel(got.detach(), want) < 1e-5
    assert _rel(ta.grad, jga) < 1e-5 and _rel(tt.grad, jgt) < 1e-5


def test_matrix_to_axis_angle_roundtrip(rng):
    aa = rng.normal(scale=0.5, size=(6, 3)).astype(np.float32)
    aa[0] = 0.0
    R = np.asarray(jse3.axis_angle_to_matrix(jnp.asarray(aa)))
    want = np.asarray(jse3.matrix_to_axis_angle(jnp.asarray(R)))
    got = tse3.matrix_to_axis_angle(_t(R)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, aa, atol=1e-5)


@pytest.mark.parametrize("min_depth,max_depth", [(0.1, None), (0.1, 100.0), (None, None)])
def test_disp_to_depth(rng, min_depth, max_depth):
    disp = rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    disp[0, 0, 0] = 0.0  # below the 1e-4 floor
    want = jdepth.disp_to_depth(jnp.asarray(disp), min_depth, max_depth)
    jg = jax.grad(lambda d: jdepth.disp_to_depth(d, min_depth, max_depth).sum())(
        jnp.asarray(disp))
    td = _t(disp, True)
    got = tdepth.disp_to_depth(td, min_depth, max_depth)
    got.sum().backward()
    assert np.all(np.isfinite(got.detach().numpy()))
    assert _rel(got.detach(), want) < 1e-6 and _rel(td.grad, jg) < 1e-6
    assert tdepth.depth_to_disp(15.0, min_depth, max_depth) == pytest.approx(
        jdepth.depth_to_disp(15.0, min_depth, max_depth))


def test_project_3d_with_behind_camera_points(rng):
    H, W = 12, 20
    depth = rng.uniform(1, 10, (2, H, W, 1)).astype(np.float32)
    K = np.tile(np.array([[0.58 * W, 0, 0.5 * W, 0], [0, 1.92 * H, 0.5 * H, 0],
                          [0, 0, 1, 0], [0, 0, 0, 1]], np.float32), (2, 1, 1))
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T[:, 2, 3] = -5.0  # pushes near points behind the camera: the z clamp
    T[1, 0, 3] = 0.3
    wgt = rng.normal(size=(2, H, W, 2)).astype(np.float32)

    def jfn(d):
        pts = jcam.backproject_depth(d, jnp.linalg.inv(K), jcam.pixel_grid(H, W))
        return jcam.project_3d(pts, K, T, H, W)

    want = jfn(jnp.asarray(depth))
    jg = jax.grad(lambda d: (jfn(d) * wgt).sum())(jnp.asarray(depth))
    td = _t(depth, True)
    pts = tcam.backproject_depth(td, _t(np.linalg.inv(K)), tcam.pixel_grid(H, W))
    got = tcam.project_3d(pts, _t(K), _t(T), H, W)
    (got * _t(wgt)).sum().backward()
    assert _rel(got.detach(), want) < 1e-5
    assert _rel(td.grad, jg) < 1e-5


def test_resize_matches(rng):
    img = rng.uniform(size=(2, 6, 10, 3)).astype(np.float32)
    for fn_j, fn_t in ((jcam.resize_bilinear, tcam.resize_bilinear),
                       (jcam.resize_nearest, tcam.resize_nearest)):
        want = np.asarray(fn_j(jnp.asarray(img), 12, 20))
        np.testing.assert_allclose(fn_t(_t(img), 12, 20).numpy(), want, atol=1e-6)


def test_scale_camera_matrix():
    """Normalised intrinsics -> pixel intrinsics and their inverse."""
    norm = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                    np.float32)
    want_K, want_inv = jcam.scale_camera_matrix(jnp.asarray(norm), 192, 640)
    got_K, got_inv = tcam.scale_camera_matrix(norm, 192, 640)
    np.testing.assert_allclose(got_K.numpy(), np.asarray(want_K), rtol=1e-6)
    np.testing.assert_allclose(got_inv.numpy(), np.asarray(want_inv), rtol=1e-5, atol=1e-8)


def _loss_inputs(rng, B=2, H=16, W=24, scales=(0, 1)):
    """A loss-input set: frames, a warped stack and disparities."""
    d = {f"rgb_{f}": rng.uniform(size=(B, H, W, 3)).astype(np.float32) for f in (-1, 0, 1)}
    for s in scales:
        d[f"pyr_{s}"] = rng.uniform(size=(B, H >> s, W >> s, 3)).astype(np.float32)
        d[f"disp_{s}"] = rng.uniform(0.05, 0.9, (B, H >> s, W >> s, 1)).astype(np.float32)
        for f in (-1, 1):
            d[f"warp_{f}_{s}"] = np.clip(
                d["rgb_0"] + rng.normal(scale=0.1, size=(B, H, W, 3)), 0, 1).astype(np.float32)
    d["tr_-1"] = rng.normal(size=(B, 3)).astype(np.float32)
    d["tr_1"] = rng.normal(size=(B, 3)).astype(np.float32)
    d["rel"] = rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32)
    d["w"] = np.array([0.5, 0.5], np.float32)
    return d


def _dicts(d, scales, conv, leaves):
    inputs = {("rgb", f, 0): conv(d[f"rgb_{f}"]) for f in (-1, 0, 1)}
    inputs.update({("rgb", 0, s): conv(d[f"pyr_{s}"]) for s in scales if s})
    inputs[("relative_distance", 0)] = conv(d["rel"][:, 0])
    inputs[("relative_distance", 1)] = conv(d["rel"][:, 1])
    outputs = {("rgb", f, s): leaves[f"warp_{f}_{s}"] for f in (-1, 1) for s in scales}
    outputs.update({("disp", s): leaves[f"disp_{s}"] for s in scales})
    outputs.update({("translation", 0, f): leaves[f"tr_{f}"] for f in (-1, 1)})
    return inputs, outputs


@pytest.mark.parametrize("prior", [0.0, 0.01])
def test_total_loss_values_and_gradients(rng, prior):
    """total_loss (no tie-break noise) and its gradients w.r.t. the warped
    images, disparities and translations; with and without the scale prior."""
    scales = (0, 1)
    d = _loss_inputs(rng, scales=scales)
    names = [k for k in d if k.startswith(("warp", "disp", "tr_"))]
    kw = dict(scales=scales, sample_weights=None, scale_prior_weight=prior,
              scale_prior_disp=0.2)

    def jfn(leaves):
        inputs, outputs = _dicts(d, scales, jnp.asarray, leaves)
        return jloss.total_loss(inputs, outputs, rng=None, **kw)

    jleaves = {k: jnp.asarray(d[k]) for k in names}
    want = jfn(jleaves)
    jgrads = jax.grad(lambda lv: jfn(lv)["loss"])(jleaves)

    tleaves = {k: _t(d[k], True) for k in names}
    inputs, outputs = _dicts(d, scales, _t, tleaves)
    got = tloss.total_loss(inputs, outputs, rng=None, **kw)
    got["loss"].backward()
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k].detach(), want[k]) < 1e-5, k
    for k in names:
        assert _rel(tleaves[k].grad, jgrads[k]) < 1e-5, k
