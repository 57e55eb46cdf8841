"""Pose helpers on the host (numpy / scipy)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def reorthonormalize_np(T: np.ndarray) -> np.ndarray:
    """Snap the rotation block of a 4x4 transform back onto SO(3) through a
    scipy quaternion round trip, as ``delora_tpu/utils/poses.py`` does."""
    quat = Rotation.from_matrix(T[:3, :3]).as_quat()
    quat = quat / np.linalg.norm(quat)
    T = T.copy()
    T[:3, :3] = Rotation.from_quat(quat).as_matrix()
    return T
