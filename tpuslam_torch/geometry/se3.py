"""SE(3) / SO(3) primitives on torch tensors.

Counterpart of `tpuslam/geometry/se3.py` (the axis-angle and quaternion
routes and `transformation_from_parameters`); the same formulas, written so
their autograd matches the JAX package's: safe norms, half-angle forms and a
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
