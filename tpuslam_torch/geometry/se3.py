"""SE(3) / SO(3) primitives on torch tensors.

Counterpart of `tpuslam/geometry/se3.py` (the axis-angle and quaternion
routes, `transformation_from_parameters`, `se3_inverse`, and the se(3)
log / exp of the pose-graph solver); the same formulas, written so their
autograd matches the JAX package's: safe norms, half-angle forms and a
wide Taylor branch keep every gradient finite at the identity.

Conventions: 4x4 row-major homogeneous matrices (camera-to-camera); an
`axis_angle` is a rotation vector (direction = axis, norm = angle, radians);
every function takes leading batch dimensions.
"""
from __future__ import annotations

import torch

_EPS = 1e-7


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) rotation vector -> (..., 3, 3) matrix,
    with the reference's `angle + 1e-7` normalisation guard."""
    # safe norm: finite gradient at exactly zero rotation
    angle = torch.sqrt((axis_angle * axis_angle).sum(-1, keepdim=True) + 1e-24)
    axis = axis_angle / (angle + _EPS)
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    C = 1.0 - ca

    x = axis[..., 0:1, None]
    y = axis[..., 1:2, None]
    z = axis[..., 2:3, None]

    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC

    row0 = torch.cat([x * xC + ca, xyC - zs, zxC + ys], dim=-1)
    row1 = torch.cat([xyC + zs, y * yC + ca, yzC - xs], dim=-1)
    row2 = torch.cat([zxC - ys, yzC + xs, z * zC + ca], dim=-1)
    return torch.cat([row0, row1, row2], dim=-2)


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _copysign(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b < 0, -a.abs(), a.abs())


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), pytorch3d convention."""
    m00 = matrix[..., 0, 0]
    m11 = matrix[..., 1, 1]
    m22 = matrix[..., 2, 2]
    o0 = 0.5 * _sqrt_positive_part(1 + m00 + m11 + m22)
    x = 0.5 * _sqrt_positive_part(1 + m00 - m11 - m22)
    y = 0.5 * _sqrt_positive_part(1 - m00 + m11 - m22)
    z = 0.5 * _sqrt_positive_part(1 - m00 - m11 + m22)
    o1 = _copysign(x, matrix[..., 2, 1] - matrix[..., 1, 2])
    o2 = _copysign(y, matrix[..., 0, 2] - matrix[..., 2, 0])
    o3 = _copysign(z, matrix[..., 1, 0] - matrix[..., 0, 1])
    return torch.stack([o0, o1, o2, o3], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3) rotation vector.

    Safe norm + wide Taylor branch: smooth (finite gradient) at the identity.
    """
    v = quaternions[..., 1:]
    norms = torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-24)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2 * half_angles
    small = angles.abs() < 1e-3
    # Taylor: sin(x/2)/x ~ 1/2 - x^2/48
    sin_half_over_angle = torch.where(
        small,
        0.5 - (angles * angles) / 48.0,
        torch.sin(half_angles) / torch.where(small, torch.ones_like(angles), angles),
    )
    return v / sin_half_over_angle


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector, via the
    quaternion route for robustness near 0 and pi."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """(..., 3) translation -> (..., 4, 4) homogeneous matrix."""
    T = torch.eye(4, dtype=t.dtype, device=t.device).expand(t.shape[:-1] + (4, 4))
    bottom = T[..., 3:, :]
    top = torch.cat([T[..., :3, :3], t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _to_homogeneous_rotation(R: torch.Tensor) -> torch.Tensor:
    zeros_col = R.new_zeros(R.shape[:-1] + (1,))
    bottom = R.new_zeros(R.shape[:-2] + (1, 4))
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, zeros_col], dim=-1), bottom], dim=-2)


def transformation_from_parameters(
    axis_angle: torch.Tensor, translation: torch.Tensor, invert: bool = False
) -> torch.Tensor:
    """Network (axis-angle, translation) output -> (..., 4, 4) SE(3).

    Forward is `T(t) @ R`; inverted is `R.T @ T(-t)` (the exact inverse of
    the forward map), as in the reference's `transformation_from_parameters`.
    """
    R = axis_angle_to_matrix(axis_angle)
    t = translation
    if invert:
        R = R.transpose(-1, -2)
        t = -t
    T = translation_matrix(t)
    Rh = _to_homogeneous_rotation(R)
    if invert:
        return Rh @ T
    return T @ Rh


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) SE(3) matrices: [R^T | -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:])
    bottom = T.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(T.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([Rt, ti], dim=-1), bottom], dim=-2)


def parameters_from_transformation(transformation: torch.Tensor):
    """(..., 4, 4) SE(3) -> (translation (..., 3), axis_angle (..., 3))."""
    return transformation[..., :3, 3], matrix_to_axis_angle(transformation[..., :3, :3])


# ---------------------------------------------------------------------------
# se(3) log / exp of the pose-graph solver.  No in-place writes, so that
# torch.func.jacfwd and vmap trace them.


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) rotation vector (robust near 0 and pi).

    Below pi / 2 the vector is the skew part of R scaled by
    theta / (2 sin theta), with theta = atan2(|skew| / 2, (tr R - 1) / 2),
    as `native/posegraph.cc` computes it; from pi / 2 on, the quaternion
    route of `matrix_to_axis_angle`.  The JAX package takes the quaternion
    route everywhere, which reads a rotation's small angles from square
    roots of its diagonal: on a matrix that is orthonormal only to rounding
    (a symmetric error e), those come out near sqrt(e) (3e-4 rad at
    e = 1e-7, float32 products) with a derivative of 0, and the pose-graph
    normal equations lose rank.  The skew part carries no symmetric error.
    Equal to the quaternion route on rotations, to rounding."""
    skew = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    cos = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    sin = 0.5 * torch.sqrt((skew * skew).sum(-1) + 1e-24)  # safe norm
    theta = torch.atan2(sin, cos)
    small = theta < 1e-3  # theta / (2 sin theta) ~ 1/2 + theta^2 / 12
    near_pi = cos < 0
    sin_safe = torch.where(small | near_pi, torch.ones_like(sin), sin)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_safe))
    return torch.where(near_pi[..., None], matrix_to_axis_angle(R), scale[..., None] * skew)


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])], dim=-1)
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom[..., None, :]], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist (v, w) -> (..., 4, 4) SE(3) via the exponential map.

    B uses 2 sin^2(theta/2), never the cancelling 1 - cos(theta), and the
    Taylor branch holds below theta = 1e-2, where its error is < 1e-9."""
    v, w = xi[..., :3], xi[..., 3:]
    sq = (w * w).sum(-1)[..., None, None]  # theta^2, smooth at 0
    W = so3_hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    small = sq < 1e-4
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    theta_safe = torch.sqrt(sq_safe)
    sin_half = torch.sin(theta_safe / 2.0)
    A = torch.where(small, 1.0 - sq / 6.0, torch.sin(theta_safe) / theta_safe)
    B = torch.where(small, 0.5 - sq / 24.0, 2.0 * sin_half ** 2 / sq_safe)
    C = torch.where(small, 1.0 / 6.0 - sq / 120.0, (1 - A) / sq_safe)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    return _homogeneous(R, (V @ v[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) SE(3) -> (..., 6) twist (v, w); the inverse of `se3_exp`.

    V^-1 = I - W / 2 + coef W^2 with coef = (1 - (theta/2) cot(theta/2)) /
    theta^2, in its half-angle form, and a Taylor branch below theta = 1e-2."""
    w = so3_log(T[..., :3, :3])
    sq = (w * w).sum(-1)[..., None, None]
    W = so3_hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    small = sq < 1e-4
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    half = torch.sqrt(sq_safe) / 2.0
    cot_term = half * torch.cos(half) / torch.sin(half)
    coef = torch.where(small, 1.0 / 12.0 + sq / 720.0, (1.0 - cot_term) / sq_safe)
    Vinv = eye - 0.5 * W + coef * W2
    v = (Vinv @ T[..., :3, 3:])[..., 0]
    return torch.cat([v, w], dim=-1)
