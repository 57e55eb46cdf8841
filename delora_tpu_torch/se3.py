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
