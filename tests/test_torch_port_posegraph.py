"""The pose-graph layer of the PyTorch port against the JAX package.

se(3) exp / log, the LM's error and normal equations, `PoseGraph.optimize`
on the noisy loop graph of `test_posegraph.py` and on a graph with point
landmarks, and the port's own ctypes wrapper of `native/posegraph.cc`.  The
port's LM runs in float64, the JAX package's in float32.
"""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

import tpuslam.posegraph.native as jax_native
from tpuslam.geometry import se3 as jse3
from tpuslam.posegraph import PoseGraph as JaxPoseGraph
from tpuslam.posegraph import graph_error as jax_graph_error
from tpuslam.posegraph.lm import _normal_equations as jax_normal_equations
from tpuslam_torch.geometry import se3
from tpuslam_torch.posegraph import lm, native
from tpuslam_torch.posegraph.graph import PoseGraph
from tpuslam_torch.posegraph.lm import graph_error, normal_equations

torch.set_num_threads(1)


def _se3(rotvec, t):
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    T[:3, 3] = t
    return T


def _chain_poses(n, rng, step=1.0):
    poses = [np.eye(4)]
    for _ in range(n - 1):
        poses.append(poses[-1] @ _se3(rng.normal(scale=0.03, size=3), [0, 0, step]))
    return poses


def _build_graph(cls, gt_poses, rng, odo_noise=0.05, loops=()):
    """`test_posegraph.py::_build_graph` for either package's PoseGraph."""
    g = cls()
    est, odo = [gt_poses[0]], []
    for i in range(1, len(gt_poses)):
        Z = np.linalg.inv(gt_poses[i - 1]) @ gt_poses[i]
        noise = _se3(rng.normal(scale=odo_noise * 0.05, size=3),
                     rng.normal(scale=odo_noise, size=3))
        odo.append(Z @ noise)
        est.append(est[-1] @ odo[-1])
    g.add_vertex(0, est[0], fixed=True)
    for i in range(1, len(gt_poses)):
        g.add_vertex(i, est[i])
        g.add_edge((i - 1, i), odo[i - 1])
    for i, j in loops:
        g.add_edge((i, j), np.linalg.inv(gt_poses[i]) @ gt_poses[j],
                   information=np.eye(6) * 2.0, is_loop_closure=True)
    return g


def _pair(seed=42, n=30, noise=0.08, loops=((0, 29),)):
    """The same noisy graph in both packages."""
    gt = _chain_poses(n, np.random.default_rng(seed))
    return (_build_graph(JaxPoseGraph, gt, np.random.default_rng(seed + 1), noise, loops),
            _build_graph(PoseGraph, gt, np.random.default_rng(seed + 1), noise, loops), gt)


def _ate(a, b):
    return float(np.sqrt(np.mean([np.sum((x[:3, 3] - y[:3, 3]) ** 2) for x, y in zip(a, b)])))


def _points_graph(cls, rng):
    """Noisy landmarks seen from fixed poses, and a noisy pose held by
    fixed landmarks (`test_point_vertices_joint_optimization`), in one
    graph."""
    gt = _chain_poses(6, rng)
    pts = rng.normal(scale=2.0, size=(4, 3)) + [0, 0, 3.0]
    noisy_pts = pts + rng.normal(scale=0.5, size=pts.shape)
    moved = gt[3] @ _se3(rng.normal(scale=0.02, size=3), rng.normal(scale=0.3, size=3))
    g = cls()
    for i, T in enumerate(gt):
        g.add_vertex(i, moved if i == 3 else T, fixed=i != 3)
    for k, p in enumerate(pts):
        g.add_vertex_point(100 + k, noisy_pts[k])
        g.add_vertex_point(200 + k, p, fixed=True)
        for i, T in enumerate(gt):
            z = np.linalg.inv(T)[:3, :3] @ (p - T[:3, 3])
            g.add_edge_pose_point(i, 100 + k, z)
            if i == 3:
                g.add_edge_pose_point(i, 200 + k, z, information=np.eye(3) * 10.0)
    g.add_edge((0, 3), np.linalg.inv(gt[0]) @ gt[3], information=np.eye(6) * 1e-6)
    return g, gt, pts


def _twists(rng):
    """Random twists, rotations at 0, 1e-6, 1e-3 (both Taylor branches and
    their edge at 1e-2) and within 1e-3 of pi."""
    v = rng.normal(size=(7, 3))
    axis = rng.normal(size=(7, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-6, 1e-3, 0.0099, 0.0101, 1.3, np.pi - 1e-3])
    return np.concatenate([v, axis * angles[:, None]], 1).astype(np.float32)


def test_se3_exp_log_match_jax(rng):
    """`se3_exp`, `se3_log` and `so3_log` in float32 against the JAX package
    on twists at theta = 0, 1e-6, 1e-3, on both sides of the Taylor branch
    at 1e-2, at 1.3, near pi, and at 5 random angles in (0.1, 2.5):
    - values within 1e-5 of the JAX package's, except where its float32
      quaternion route reads a small angle from a square root of rounding
      (theta < 1e-2), within 5e-5 there; the port's within 2e-5 of the twist;
    - gradients of a random contraction of exp (all twists) and of log(exp)
      and so3_log(exp) (the random angles and 1.3) within 1e-4 relative of
      the JAX package's;
    - log(exp) is the identity, so its gradient is the contraction itself:
      the port's within 1e-5 relative of it at every twist but the one near
      pi (float32 rounding there: float64 within 1e-6), where the JAX
      package's float32 gradient is off by up to 100% at theta = 0;
    - float64 gradients finite at the identity and near pi."""
    xi = _twists(rng)
    axis = rng.normal(size=(5, 3))
    wide = np.concatenate([rng.normal(size=(5, 3)), axis / np.linalg.norm(axis, axis=1,
                          keepdims=True) * rng.uniform(0.1, 2.5, (5, 1))], 1)
    xi = np.concatenate([xi, wide.astype(np.float32)])
    theta = np.linalg.norm(xi[:, 3:], axis=1)
    w4 = rng.normal(size=(4, 4)).astype(np.float32)
    w6 = rng.normal(size=6).astype(np.float32)
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    got = se3.se3_log(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, xi, atol=2e-5)
    for fn, jfn, x in ((se3.se3_log, jse3.se3_log, T), (se3.so3_log, jse3.so3_log, T[:, :3, :3])):
        diff = np.abs(fn(torch.from_numpy(x)).numpy() - np.asarray(jfn(jnp.asarray(x)))).max(1)
        assert (diff <= np.where(theta < 1e-2, 5e-5, 1e-5)).all(), (fn.__name__, diff)
    for name, fn, jfn, w, ks in (
            ("exp", se3.se3_exp, jse3.se3_exp, w4, range(len(xi))),
            ("log(exp)", lambda a: se3.se3_log(se3.se3_exp(a)),
             lambda a: jse3.se3_log(jse3.se3_exp(a)), w6, np.nonzero(theta > 0.05)[0]),
            ("so3_log(exp)", lambda a: se3.so3_log(se3.se3_exp(a)[..., :3, :3]),
             lambda a: jse3.so3_log(jse3.se3_exp(a)[..., :3, :3]), w6[:3],
             np.nonzero(theta > 0.05)[0])):
        jvg = jax.jit(jax.value_and_grad(lambda a: (jfn(a) * w).sum()))
        for k in ks:
            if abs(theta[k] - np.pi) < 0.01 and name != "exp":
                continue  # float32 rounding near pi: held in float64 below
            want, jg = jvg(jnp.asarray(xi[k]))
            t = torch.from_numpy(xi[k]).requires_grad_()
            got = (fn(t) * torch.from_numpy(w)).sum()
            got.backward()
            assert abs(float(got) - float(want)) <= 1e-5 * (1 + abs(float(want))), (name, k)
            g = t.grad.numpy()
            assert np.linalg.norm(g - jg) <= 1e-4 * np.linalg.norm(jg) + 1e-6, (name, k)
    for k in range(len(xi)):
        dtype, tol = (torch.float64, 1e-6) if abs(theta[k] - np.pi) < 0.01 else (torch.float32, 1e-5)
        t = torch.from_numpy(xi[k]).to(dtype).requires_grad_()
        (se3.se3_log(se3.se3_exp(t)) * torch.from_numpy(w6).to(dtype)).sum().backward()
        assert np.linalg.norm(t.grad.numpy() - w6) <= tol * np.linalg.norm(w6), k
    for x in (xi, T):
        t = torch.from_numpy(x).double().requires_grad_()
        (se3.se3_log(se3.se3_exp(t)) if x is xi else se3.se3_log(t)).sum().backward()
        assert torch.isfinite(t.grad).all()
    tr, aa = se3.parameters_from_transformation(torch.from_numpy(T))
    jtr, jaa = jse3.parameters_from_transformation(jnp.asarray(T))
    np.testing.assert_allclose(tr.numpy(), jtr, atol=1e-6)
    np.testing.assert_allclose(aa.numpy(), jaa, atol=1e-5)


def test_so3_log_ignores_a_symmetric_rounding_error():
    """A rotation of 1e-6 rad whose matrix carries a symmetric error of 1e-8
    (as products of float32 poses do): the port's `so3_log` returns the
    rotation within 1e-12 and its derivative along the rotation is 1; the
    quaternion route of the JAX package (`matrix_to_axis_angle`, the same
    formula in both packages) reads the error as a rotation of ~1e-4 rad,
    in float64 too: the reason the port's LM takes the skew part."""
    w = np.array([1e-6, 0.0, 0.0])
    R = Rotation.from_rotvec(w).as_matrix() + 1e-8 * np.diag([1.0, -1.0, -1.0])
    got = se3.so3_log(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, w, atol=1e-12)
    assert np.abs(se3.matrix_to_axis_angle(torch.from_numpy(R)).numpy() - w).max() > 1e-5
    t = torch.zeros(6, dtype=torch.float64, requires_grad=True)
    se3.so3_log(se3.se3_exp(t)[:3, :3] @ torch.from_numpy(R))[0].backward()
    np.testing.assert_allclose(t.grad[3:].numpy(), [1.0, 0.0, 0.0], atol=1e-6)


def _numeric_normal_equations(g):
    """H and b from central differences (step 1e-6) of the port's float64
    residuals: the reference the LM's forward-mode Jacobians are held to."""
    N = g.poses.shape[0]
    D = 6 * N + 3 * g.points.shape[0]
    H, b = np.zeros((D, D)), np.zeros(D)
    blocks = [(lm._edge_residual_delta, 12, (g.poses[i], g.poses[j], Z), info,
               np.r_[6 * i:6 * i + 6, 6 * j:6 * j + 6])
              for (i, j), Z, info in zip(g.edges.tolist(), g.measurements, g.information)]
    blocks += [(lm._point_residual_delta, 9, (g.poses[i], g.points[p], z), info,
                np.r_[6 * i:6 * i + 6, 6 * N + 3 * p:6 * N + 3 * p + 3])
               for (i, p), z, info in zip(g.pp_edges.tolist(), g.pp_measurements,
                                          g.pp_information)]
    for fn, n, args, info, rows in blocks:
        step = 1e-6 * torch.eye(n, dtype=torch.float64)
        J = torch.stack([(fn(step[k], *args) - fn(-step[k], *args)) / 2e-6
                         for k in range(n)], 1).numpy()
        r = fn(torch.zeros(n, dtype=torch.float64), *args).numpy()
        H[np.ix_(rows, rows)] += J.T @ info.numpy() @ J
        b[rows] += J.T @ info.numpy() @ r
    return H, b


@pytest.mark.parametrize("points", [False, True])
def test_graph_error_and_normal_equations_match_jax(points):
    """The weighted error and the normal equations (H, b) of the same graph.
    The port's float64 H and b within 1e-6 relative of central differences
    of its residuals; error and b within 1e-5 relative of the JAX package's
    float32 ones, H within 1e-5 on the graph with points and within 5e-3 on
    the loop graph, whose near-zero rotation residuals the JAX package's
    float32 quaternion route differentiates from rounding (the JAX H is
    padded to its bucket, of which the port's is the leading block)."""
    if points:
        gj, _, _ = _points_graph(JaxPoseGraph, np.random.default_rng(3))
        gt_, _, _ = _points_graph(PoseGraph, np.random.default_rng(3))
    else:
        gj, gt_, _ = _pair()
    ja, _ = gj.to_arrays()
    ta, _ = gt_.to_arrays("cpu")
    assert ta.poses.dtype == torch.float64
    e, je = float(graph_error(ta)), float(jax_graph_error(ja))
    assert abs(e - je) <= 1e-5 * je, (e, je)
    H, b = (x.numpy() for x in normal_equations(ta))
    nH, nb = _numeric_normal_equations(ta)
    assert np.linalg.norm(H - nH) <= 1e-6 * np.linalg.norm(nH)
    assert np.linalg.norm(b - nb) <= 1e-6 * np.linalg.norm(nb)
    jH, jb = (np.asarray(x, np.float64) for x in jax.jit(jax_normal_equations)(ja))
    N, P = ta.poses.shape[0], ta.points.shape[0]
    rows = np.r_[0:6 * N, 6 * len(ja.poses) + np.arange(3 * P)]
    jH, jb = jH[np.ix_(rows, rows)], jb[rows]
    assert np.linalg.norm(H - jH) <= (1e-5 if points else 5e-3) * np.linalg.norm(jH)
    assert np.linalg.norm(b - jb) <= 1e-5 * np.linalg.norm(jb)


def test_optimize_torch_matches_jax_and_native():
    """The noisy 30-vertex loop graph: the port's float64 LM reaches at
    least the JAX float32 LM's error (within `test_native_solver_matches_jax`'s
    1.5x) and poses within its ATE of 0.15; against the C++ solver, which
    runs the same schedule in double, error within 1e-9 relative and poses
    within 1e-5."""
    gj, gt_, gt = _pair()
    gn = _build_graph(PoseGraph, gt, np.random.default_rng(43), 0.08, [(0, 29)])
    ej = gj.optimize(max_iterations=25, backend="jax")
    et = gt_.optimize(max_iterations=25, backend="torch", device="cpu")
    en = gn.optimize(max_iterations=25, backend="native")
    assert (gt_.last_backend, gn.last_backend) == ("torch", "native")
    assert et <= ej * 1.5 + 1e-6, (et, ej)
    assert _ate(gt_.get_all_poses(), gj.get_all_poses()) < 0.15
    assert abs(et - en) <= 1e-9 * en, (et, en)
    np.testing.assert_allclose(np.stack(gt_.get_all_poses()), np.stack(gn.get_all_poses()),
                               atol=1e-5)
    assert _ate(gt_.get_all_poses(), gt) < _ate(_pair()[1].get_all_poses(), gt)


def test_optimize_with_points_matches_jax():
    """Landmarks and a pose solved jointly: the port's LM against the JAX
    LM's result within 1e-3 (points, and the pose's translation), and both
    at the ground truth (points within 1e-3, pose within 0.05 of it).
    "auto" takes the torch backend for a graph with points; "native"
    refuses it."""
    gj, gt, pts = _points_graph(JaxPoseGraph, np.random.default_rng(5))
    g, _, _ = _points_graph(PoseGraph, np.random.default_rng(5))
    ej = gj.optimize(max_iterations=50, backend="jax")
    e = g.optimize(max_iterations=50, backend="auto", device="cpu")
    assert g.last_backend == "torch" and e < 1e-6 and ej < 1e-4
    np.testing.assert_allclose(np.stack(g.get_all_points()), np.stack(gj.get_all_points()),
                               atol=1e-3)
    np.testing.assert_allclose(np.stack(g.get_all_points())[:4], pts, atol=1e-3)
    np.testing.assert_allclose(g.get_pose(3)[:3, 3], gj.get_pose(3)[:3, 3], atol=1e-3)
    assert np.linalg.norm(g.get_pose(3)[:3, 3] - gt[3][:3, 3]) < 0.05
    with pytest.raises(ValueError, match="pose-only"):
        g.optimize(backend="native")


def test_native_wrapper_is_bit_identical_to_jax_packages(monkeypatch, tmp_path):
    """The port's `optimize_native` and the JAX package's, on the same
    arrays: the same source built with the same flags, so the same bits.
    The JAX package's library is built into `tmp_path` here, so that
    `native/` is neither read nor written.  `graph_error_native` equals the
    port's float64 `graph_error` within 1e-12 relative."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", tmp_path / "libposegraph.so")
    monkeypatch.setattr(jax_native, "_lib", None)
    if not jax_native.is_available():
        pytest.fail(f"the JAX package's native build failed: {jax_native._build_error}")
    assert native.is_available(), native._build_error
    assert native.library_path().parent.name == "build"
    _, g, _ = _pair(n=40, loops=((0, 39), (5, 33)))
    ids, poses, fixed, edges = g._pose_arrays()
    Z, info = np.stack(g._measurements), np.stack(g._information)
    got, err = native.optimize_native(poses, fixed, edges, Z, info, max_iterations=50)
    want, jerr = jax_native.optimize_native(poses, fixed, edges, Z, info, max_iterations=50)
    np.testing.assert_array_equal(got, want)
    assert err == jerr
    arrays, _ = g.to_arrays("cpu")
    e = native.graph_error_native(poses, edges, Z, info)
    assert abs(e - float(graph_error(arrays))) <= 1e-12 * e


@pytest.mark.parametrize("backend", ["torch", "native"])
def test_fixed_vertex_and_noise_free_fixed_point(backend):
    """A fixed vertex never moves (first vertex, and an interior one); a
    noise-free graph is a fixed point (error < 1e-6, ATE < 1e-4); with no
    fixed vertex the first is pinned."""
    rng = np.random.default_rng(11)
    gt = _chain_poses(12, rng)
    g = _build_graph(PoseGraph, gt, rng, 0.1, [(0, 11)])
    g.add_vertex(5, g.get_pose(5), fixed=True)
    first, mid = g.get_pose(0), g.get_pose(5)
    g.optimize(max_iterations=10, backend=backend, device="cpu")
    np.testing.assert_array_equal(g.get_pose(0), first)
    np.testing.assert_array_equal(g.get_pose(5), mid)

    g = _build_graph(PoseGraph, _chain_poses(10, rng), rng, 0.0)
    before = g.get_all_poses()
    assert g.optimize(max_iterations=5, backend=backend, device="cpu") < 1e-6
    assert _ate(before, g.get_all_poses()) < 1e-4

    g = PoseGraph()
    g.add_vertex(0, gt[0])
    g.add_vertex(1, gt[1] @ _se3([0, 0, 0], [0.3, 0, 0]))
    g.add_edge((0, 1), np.linalg.inv(gt[0]) @ gt[1])
    g.optimize(max_iterations=20, backend=backend, device="cpu")
    np.testing.assert_array_equal(g.get_pose(0), gt[0])
    np.testing.assert_allclose(g.get_pose(1), gt[1], atol=1e-6)


def test_api_queries_match_jax():
    """Vertex and edge queries, the loop counter, `__str__`, the id guards
    and the unported viz entry point."""
    T = _se3([0, 0.05, 0], [0, 0, 1])
    graphs = []
    for cls in (JaxPoseGraph, PoseGraph):
        g = cls()
        g.add_vertex(0, np.eye(4), fixed=True)
        g.add_vertex(1, T)
        g.add_vertex(5, T @ T)
        g.add_edge((0, 1), T)
        g.add_edge((1, 5), T, is_loop_closure=True)
        graphs.append(g)
    jg, g = graphs
    assert g.vertex_ids == jg.vertex_ids == [0, 1, 5]
    for a, b in ((1, 0), (0, 5), (5, 1)):
        assert g.does_edge_exists(a, b) == jg.does_edge_exists(a, b)
    for v in (0, 1, 5):
        assert g.is_vertex_in_any_edge(v) == jg.is_vertex_in_any_edge(v)
        assert (g.does_vertex_have_only_global_edges(v)
                == jg.does_vertex_have_only_global_edges(v))
    assert g.num_loop_closures == jg.num_loop_closures == 1
    assert str(g) == str(jg)
    np.testing.assert_array_equal(g.get_transform(0, 5), jg.get_transform(0, 5))
    with pytest.raises(KeyError):
        g.add_vertex_point(0, np.zeros(3))
    with pytest.raises(KeyError):
        g.add_edge((0, 7), T)
    assert PoseGraph().optimize(backend="torch", device="cpu") == 0.0
    with pytest.raises(ValueError, match="unknown pose-graph backend"):
        g.optimize(backend="jax")
    with pytest.raises(NotImplementedError, match="Queue 1, item 5"):
        g.visualize_in_meshlab("graph.obj")
