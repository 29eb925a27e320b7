"""Levenberg-Marquardt pose-graph optimisation over SE(3) (+ points), in torch.

Counterpart of `tpuslam/posegraph/lm.py`, in float64 on the device the
graph's tensors lie on (the JAX package runs float32 only because the TPU
has no float64; `native/posegraph.cc` works in double too):

* residual per pose-pose edge (i, j, Z, Info): r = log(Z^-1 X_i^-1 X_j) in
  R^6, the relative-pose error of g2o's EdgeSE3;
* residual per pose-point edge (i, p, z, Info3): r = X_i^-1 p - z in R^3
  (g2o's EdgeSE3PointXYZ with an identity sensor offset), solved jointly
  with the poses;
* the rotation log reads small angles from the skew part
  (`geometry/se3.py::so3_log`), as the C++ solver does;
* per-edge Jacobians with respect to left-applied tangent deltas of the
  incident vertices from `torch.func.jacfwd` under `torch.func.vmap`;
* normal equations assembled by scatter-add of the per-edge blocks into a
  dense (6N + 3P)^2 H, solved by Cholesky with multiplicative damping;
  fixed vertices are pinned as identity rows;
* accept / reject on the true error, with early termination when an
  accepted step gains less than `gain_tolerance` relatively or the damping
  saturates.  The host reads one scalar per iteration.

The graph is not padded: the JAX package pads to power-of-two buckets only
so that XLA compiles one program per bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from tpuslam_torch.geometry.se3 import se3_exp, se3_inverse, se3_log


@dataclasses.dataclass
class GraphArrays:
    """A pose graph as tensors on one device.

    poses (N, 4, 4); fixed (N,) bool (True = held constant); edges (M, 2)
    int64; measurements (M, 4, 4); information (M, 6, 6).  Point blocks, of
    size 0 when the graph has none: points (P, 3); point_fixed (P,) bool;
    pp_edges (Q, 2) int64 rows of (pose index, point index);
    pp_measurements (Q, 3) points in the pose frame; pp_information
    (Q, 3, 3)."""

    poses: torch.Tensor
    fixed: torch.Tensor
    edges: torch.Tensor
    measurements: torch.Tensor
    information: torch.Tensor
    points: torch.Tensor
    point_fixed: torch.Tensor
    pp_edges: torch.Tensor
    pp_measurements: torch.Tensor
    pp_information: torch.Tensor


def edge_residual(X_i: torch.Tensor, X_j: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """r = log(Z^-1 X_i^-1 X_j) in R^6 (v, w)."""
    return se3_log(se3_inverse(Z) @ (se3_inverse(X_i) @ X_j))


def point_residual(X_i: torch.Tensor, p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """r = X_i^-1 p - z in R^3 (the point measured in the pose frame)."""
    R, t = X_i[..., :3, :3], X_i[..., :3, 3]
    return (R.transpose(-1, -2) @ (p - t)[..., None])[..., 0] - z


def _edge_residual_delta(delta, X_i, X_j, Z):
    """Edge residual after left-applying tangent deltas to both endpoints."""
    return edge_residual(se3_exp(delta[:6]) @ X_i, se3_exp(delta[6:]) @ X_j, Z)


def _point_residual_delta(delta, X_i, p, z):
    """Point residual after a pose tangent delta (6) and a point delta (3)."""
    return point_residual(se3_exp(delta[:6]) @ X_i, p + delta[6:], z)


_edge_jacobian = vmap(jacfwd(_edge_residual_delta), in_dims=(None, 0, 0, 0))
_point_jacobian = vmap(jacfwd(_point_residual_delta), in_dims=(None, 0, 0, 0))


def _weighted(r: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Per-edge r^T Info r."""
    return (r * (info @ r[..., None])[..., 0]).sum(-1)


def graph_error(g: GraphArrays) -> torch.Tensor:
    """Total weighted squared error over all edges (0-d tensor)."""
    err = _weighted(edge_residual(g.poses[g.edges[:, 0]], g.poses[g.edges[:, 1]],
                                  g.measurements), g.information).sum()
    if len(g.pp_edges):
        rp = point_residual(g.poses[g.pp_edges[:, 0]], g.points[g.pp_edges[:, 1]],
                            g.pp_measurements)
        err = err + _weighted(rp, g.pp_information).sum()
    return err


def _scatter_blocks(H, b, rows, J, r, info):
    """Add each edge's J^T Info J and J^T Info r at its rows of H and b."""
    Jt = J.transpose(1, 2)
    H_e = Jt @ (info @ J)
    b_e = (Jt @ (info @ r[..., None]))[..., 0]
    n = rows.shape[1]
    H.index_put_((rows[:, :, None].expand(-1, n, n), rows[:, None, :].expand(-1, n, n)),
                 H_e, accumulate=True)
    b.index_put_((rows,), b_e, accumulate=True)


def normal_equations(g: GraphArrays) -> Tuple[torch.Tensor, torch.Tensor]:
    """H (6N+3P, 6N+3P) and b by scatter-add of the 12x12 pose-pose and
    9x9 pose-point blocks."""
    N, P = g.poses.shape[0], g.points.shape[0]
    D = 6 * N + 3 * P
    dtype, device = g.poses.dtype, g.poses.device
    H = torch.zeros((D, D), dtype=dtype, device=device)
    b = torch.zeros((D,), dtype=dtype, device=device)
    offs = torch.arange(6, device=device)
    Xi, Xj = g.poses[g.edges[:, 0]], g.poses[g.edges[:, 1]]
    r = edge_residual(Xi, Xj, g.measurements)
    J = _edge_jacobian(torch.zeros(12, dtype=dtype, device=device), Xi, Xj, g.measurements)
    rows = torch.cat([g.edges[:, :1] * 6 + offs, g.edges[:, 1:] * 6 + offs], dim=1)
    _scatter_blocks(H, b, rows, J, r, g.information)
    if len(g.pp_edges):
        Xp, pts = g.poses[g.pp_edges[:, 0]], g.points[g.pp_edges[:, 1]]
        rp = point_residual(Xp, pts, g.pp_measurements)
        Jp = _point_jacobian(torch.zeros(9, dtype=dtype, device=device), Xp, pts,
                             g.pp_measurements)
        prows = torch.cat([g.pp_edges[:, :1] * 6 + offs,
                           6 * N + g.pp_edges[:, 1:] * 3 + torch.arange(3, device=device)],
                          dim=1)
        _scatter_blocks(H, b, prows, Jp, rp, g.pp_information)
    return H, b


def fixed_variables(g: GraphArrays) -> torch.Tensor:
    """Indices into the (6N + 3P) unknowns of the fixed vertices' ones."""
    fixed = torch.cat([g.fixed.repeat_interleave(6), g.point_fixed.repeat_interleave(3)])
    return torch.nonzero(fixed)[:, 0]


def masked_solve(H: torch.Tensor, b: torch.Tensor, fixed: torch.Tensor, lam: float):
    """Solve (H + lam diag(H)) d = -b with the unknowns at indices `fixed`
    pinned to d = 0 (identity rows and columns).  Returns (d, Cholesky
    info): info is nonzero where the damped system is not positive
    definite."""
    Hd = H.clone()
    Hd.diagonal().add_(lam * torch.diagonal(H).clamp_min(1e-8))
    Hd[fixed] = 0.0
    Hd[:, fixed] = 0.0
    Hd[fixed, fixed] = 1.0
    rhs = -b
    rhs[fixed] = 0.0
    L, info = torch.linalg.cholesky_ex(Hd)
    return torch.cholesky_solve(rhs[:, None], L)[:, 0], info


def apply_delta(g: GraphArrays, delta: torch.Tensor) -> GraphArrays:
    N = g.poses.shape[0]
    poses = se3_exp(delta[:6 * N].reshape(-1, 6)) @ g.poses
    return dataclasses.replace(g, poses=poses, points=g.points + delta[6 * N:].reshape(-1, 3))


def lm_optimize(
    g: GraphArrays,
    max_iterations: int = 20,
    initial_lambda: float = 1e-4,
    gain_tolerance: float = 1e-9,
) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """LM with accept / reject damping (x0.5 on accept down to 1e-9, x4 on
    reject up to 1e6) and g2o-style early termination: stops when an
    accepted step improves the error by less than `gain_tolerance`
    relatively, when rejected at 1e6 damping, or at `max_iterations`.

    Returns (optimised poses (N, 4, 4), optimised points (P, 3), final error).
    """
    fixed = fixed_variables(g)
    lam = initial_lambda
    with torch.no_grad():
        err = float(graph_error(g))
        for _ in range(max_iterations):
            H, b = normal_equations(g)
            delta, info = masked_solve(H, b, fixed, lam)
            cand = apply_delta(g, delta)
            # a failed factorisation rejects the step, as the NaN it gives does
            new_err = float(torch.where(info == 0, graph_error(cand), torch.inf))
            accept = new_err < err
            if accept:
                converged = err - new_err < gain_tolerance * max(err, 1e-30)
                g, err = cand, new_err
                lam = max(lam * 0.5, 1e-9)
                if converged:
                    break
            elif lam >= 1e6:
                break
            else:
                lam = min(lam * 4.0, 1e6)
    return g.poses, g.points, err
