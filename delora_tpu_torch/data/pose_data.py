"""Ground-truth poses of KITTI sequences: ``<pose_data_path>/<seq:02d>.txt``,
12 floats a scan (the rows of [R | t]). A copy of
``delora_tpu/data/pose_data.py``; a sequence without ground truth gives
None."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def load_kitti_poses(config, dataset: str, sequence_id: int) -> Optional[np.ndarray]:
    """-> [K, 4, 4] absolute poses, or None if no ground truth is configured
    or the file is missing."""
    base = config[dataset].get("pose_data_path")
    if not base:
        return None
    path = os.path.join(base, format(sequence_id, "02d") + ".txt")
    if not os.path.exists(path):
        print(f"[poses] Groundtruth file {path} does not exist; skipping.")
        return None
    rows = np.loadtxt(path).reshape(-1, 12)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :4] = rows.reshape(-1, 3, 4)
    return poses


def gt_translations(poses: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """The translation columns [3, 7, 11] of the 12-value rows."""
    if poses is None:
        return None
    return poses[:, :3, 3]
