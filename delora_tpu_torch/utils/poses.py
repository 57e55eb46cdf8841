"""Pose chaining, KITTI trajectory files and odometry error metrics, on the
host (numpy / scipy). A copy of ``delora_tpu/utils/poses.py``: relative
transforms (lidar frame) are chained into world-frame poses through the fixed
lidar -> camera axis permutation and re-orthonormalized after every
composition; the KITTI odometry metric averages the relative error over
100..800 m subsequences, and sequences too short for it get the per-step
relative pose error.
"""

from __future__ import annotations

import csv
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

# Fixed lidar -> world (camera) frame permutation.
TRANSFORM_LIDAR_TO_WORLD = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def reorthonormalize_np(T: np.ndarray) -> np.ndarray:
    """Snap the rotation block of a 4x4 transform back onto SO(3) through a
    scipy quaternion round trip."""
    quat = Rotation.from_matrix(T[:3, :3]).as_quat()
    quat = quat / np.linalg.norm(quat)
    T = T.copy()
    T[:3, :3] = Rotation.from_quat(quat).as_matrix()
    return T


def check_validity_so3(R: np.ndarray, atol: float = 1e-6) -> bool:
    det_valid = np.isclose(np.linalg.det(R), 1.0, atol=atol)
    inv_valid = np.allclose(R.T @ R, np.eye(3), atol=atol)
    return bool(det_valid and inv_valid)


def compute_poses(relative_transforms: Sequence[np.ndarray]) -> np.ndarray:
    """Chain T_k,k+1 (lidar frame) -> absolute world-frame poses
    [K+1, 4, 4], starting at the identity."""
    world = TRANSFORM_LIDAR_TO_WORLD
    world_inv = world.T
    T_lidar = np.eye(4)
    poses = [np.eye(4)]
    for T_rel in relative_transforms:
        T_lidar = reorthonormalize_np(T_lidar @ np.asarray(T_rel).reshape(4, 4))
        T_world = world @ T_lidar @ world_inv
        if not check_validity_so3(T_world[:3, :3]):
            raise ValueError("Pose is not a valid SO(3) rotation")
        poses.append(T_world)
    return np.stack(poses)


def write_poses_to_text_file(file_name: str, poses: np.ndarray) -> None:
    """KITTI 12-value rows."""
    with open(file_name, "w", newline="") as f:
        writer = csv.writer(f, delimiter=" ")
        for pose in poses:
            writer.writerow(np.asarray(pose).reshape(16)[:12].tolist())


def read_poses_from_text_file(file_name: str) -> np.ndarray:
    """KITTI pose file -> [K, 4, 4]."""
    rows = np.loadtxt(file_name).reshape(-1, 12)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :4] = rows.reshape(-1, 3, 4)
    return poses


KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(d)])


def _first_frame_past(dist: np.ndarray, start: int, length: float) -> int:
    idx = np.searchsorted(dist, dist[start] + length, side="left")
    return int(idx) if idx < len(dist) else -1


def kitti_odometry_errors(poses_gt: np.ndarray, poses_est: np.ndarray,
                          lengths: Sequence[float] = KITTI_LENGTHS, step: int = 10
                          ) -> List[Tuple[int, float, float, float]]:
    """Per-subsequence errors: (first_frame, r_err [rad/m], t_err [ratio],
    length)."""
    n = min(len(poses_gt), len(poses_est))
    poses_gt, poses_est = poses_gt[:n], poses_est[:n]
    dist = trajectory_distances(poses_gt)
    errors = []
    for first in range(0, n, step):
        for length in lengths:
            last = _first_frame_past(dist, first, length)
            if last < 0:
                continue
            delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            delta_est = np.linalg.inv(poses_est[first]) @ poses_est[last]
            err = np.linalg.inv(delta_est) @ delta_gt
            t_err = np.linalg.norm(err[:3, 3]) / length
            cos = np.clip((np.trace(err[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
            errors.append((first, float(np.arccos(cos) / length), float(t_err), float(length)))
    return errors


def relative_pose_errors_summary(poses_gt: np.ndarray, poses_est: np.ndarray
                                 ) -> Optional[Tuple[float, float]]:
    """Per-step relative pose error -> (mean translation error m, mean
    rotation error deg), or None with fewer than two poses."""
    n = min(len(poses_gt), len(poses_est))
    if n < 2:
        return None
    errs_t, errs_r = [], []
    for i in range(n - 1):
        g = np.linalg.inv(poses_gt[i]) @ poses_gt[i + 1]
        e = np.linalg.inv(poses_est[i]) @ poses_est[i + 1]
        d = np.linalg.inv(e) @ g
        errs_t.append(np.linalg.norm(d[:3, 3]))
        errs_r.append(np.arccos(np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
    return float(np.mean(errs_t)), float(np.degrees(np.mean(errs_r)))


def kitti_benchmark_summary(poses_gt: np.ndarray, poses_est: np.ndarray
                            ) -> Optional[Tuple[float, float]]:
    """-> (t_rel %, r_rel deg/100m) averaged over all subsequences, or None
    when the trajectory has no 100 m subsequence."""
    errors = kitti_odometry_errors(poses_gt, poses_est)
    if not errors:
        return None
    t_rel = float(np.mean([e[2] for e in errors])) * 100.0
    r_rel = float(np.mean([e[1] for e in errors])) * 180.0 / np.pi * 100.0
    return t_rel, r_rel
