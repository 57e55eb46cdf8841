"""KITTI velodyne scan reader."""

from __future__ import annotations

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """One scan -> [N, 4] float32 (x, y, z, intensity)."""
    data = np.fromfile(path, dtype=np.float32)
    if data.size % 4 != 0:
        raise ValueError(f"Corrupt velodyne file (size % 4 != 0): {path}")
    return data.reshape(-1, 4)
