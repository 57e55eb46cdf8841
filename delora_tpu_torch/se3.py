"""Quaternion / rotation / SE(3) math on tensors, batched over leading axes.

Conventions as in ``delora_tpu/se3.py``: quaternions are ``(x, y, z, w)``,
``quat_to_rotmat`` normalizes per row, points are row vectors ``[..., N, 3]``
and transforms ``[..., 4, 4]``.
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) along the last axis."""
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w), any scale -> rotation matrix [..., 3, 3]."""
    q = normalize_quat(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def axis_angle_to_rotmat(aa: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Axis-angle vectors [..., 3] (angle = |aa|) -> rotation matrices
    [..., 3, 3] by Rodrigues' formula; an angle below ``eps`` gives the
    identity."""
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    axis = aa / torch.clamp(angle, min=eps)
    x, y, z = axis.unbind(-1)
    theta = angle[..., 0]
    c, s = torch.cos(theta), torch.sin(theta)
    C = 1.0 - c
    row0 = torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], dim=-1)
    row1 = torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], dim=-1)
    row2 = torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], dim=-1)
    R = torch.stack([row0, row1, row2], dim=-2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    return torch.where((theta < eps)[..., None, None], eye, R)


def make_transform(translation: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] from translation [..., 3] and rotation [..., 3, 3]."""
    T = rotation.new_zeros(rotation.shape[:-2] + (4, 4))
    T[..., :3, :3] = rotation
    T[..., :3, 3] = translation
    T[..., 3, 3] = 1.0
    return T


def transform_from_quat(translation: torch.Tensor, quat_xyzw: torch.Tensor) -> torch.Tensor:
    return make_transform(translation, quat_to_rotmat(quat_xyzw))


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to points [..., N, 3] -> [..., N, 3] (rotate + translate)."""
    return points @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def rotate_points(T_or_R: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate only (for normals)."""
    return points @ T_or_R[..., :3, :3].transpose(-1, -2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit quaternions (x, y, z, w).

    Each component's magnitude comes from the diagonal, its sign from the
    antisymmetric part (``copysign``, so a difference of +0 or -0 near 180
    degrees keeps or flips the component as the reference does); w >= 0."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = 0.5 * torch.sqrt(torch.clamp(1.0 + r00 + r11 + r22, min=0.0))
    qx = 0.5 * torch.sqrt(torch.clamp(1.0 + r00 - r11 - r22, min=0.0))
    qy = 0.5 * torch.sqrt(torch.clamp(1.0 - r00 + r11 - r22, min=0.0))
    qz = 0.5 * torch.sqrt(torch.clamp(1.0 - r00 - r11 + r22, min=0.0))
    qx = torch.copysign(qx, r21 - r12)
    qy = torch.copysign(qy, r02 - r20)
    qz = torch.copysign(qz, r10 - r01)
    return normalize_quat(torch.stack([qx, qy, qz, qw], dim=-1))


def compose(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """T_a @ T_b."""
    return T_a @ T_b


def invert(T: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid transforms [..., 4, 4]: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(-(Rt @ T[..., :3, 3:4])[..., 0], Rt)


def reorthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Snap the rotation block back onto SO(3) through a quaternion round
    trip; the translation is kept."""
    return make_transform(T[..., :3, 3], quat_to_rotmat(rotmat_to_quat(T[..., :3, :3])))


def matrix_to_euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> (yaw, pitch, roll) Tait-Bryan ZYX angles:
    yaw = atan2(R10, R00), pitch = asin(-R20) (clamped to [-1, 1]),
    roll = atan2(R21, R22)."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def quat_wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 1:], q[..., :1]], dim=-1)


def quat_xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 3:], q[..., :3]], dim=-1)


def rotation_geodesic_angle(R_a: torch.Tensor, R_b: torch.Tensor) -> torch.Tensor:
    """Angle of R_a^T R_b in radians; its cosine is clamped to [-1, 1]."""
    M = R_a.transpose(-1, -2) @ R_b
    cos = (M.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5
    return torch.acos(torch.clamp(cos, -1.0, 1.0))
