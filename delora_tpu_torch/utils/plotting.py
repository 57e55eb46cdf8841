"""Trajectory and range-image plotting (matplotlib, on the host).

The port's copy of ``delora_tpu/utils/plotting.py``: the 2D, 3D and
elevation maps of a predicted trajectory against the ground truth, the
per-axis relative translation and rotation against the ground truth, the
stacked single-channel image grid of the preprocessing preview, and the
six-panel training diagnostic. matplotlib is imported here, at the top, with
the Agg backend: a caller without matplotlib gets the ImportError when it
imports this module, before it computes anything to plot.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def plot_trajectory(
    poses: np.ndarray,
    gt_poses: Optional[np.ndarray],
    path: str,
    title: str = "",
) -> None:
    """2D (x-z plane, KITTI convention) predicted vs ground-truth path."""
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(poses[:, 0, 3], poses[:, 2, 3], label="predicted", linewidth=1.2)
    if gt_poses is not None:
        ax.plot(gt_poses[:, 0, 3], gt_poses[:, 2, 3], label="groundtruth",
                linewidth=1.2, alpha=0.8)
    travelled = float(
        np.sum(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=-1))
    )
    ax.set_title(f"{title}  (travelled {travelled:.0f} m)")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_trajectory_3d(
    poses: np.ndarray, gt_poses: Optional[np.ndarray], path: str, title: str = ""
) -> None:
    """3D predicted-vs-GT path (plotting.py:137-146 analog)."""
    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(projection="3d")
    ax.plot(poses[:, 0, 3], poses[:, 2, 3], poses[:, 1, 3],
            label="predicted", linewidth=1.0)
    if gt_poses is not None:
        ax.plot(gt_poses[:, 0, 3], gt_poses[:, 2, 3], gt_poses[:, 1, 3],
                label="groundtruth", linewidth=1.0, alpha=0.8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_zlabel("y [m]")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_elevation(poses: np.ndarray, gt_poses: Optional[np.ndarray], path: str):
    """Elevation (y) over scan index (plotting.py:147-163)."""
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(poses[:, 1, 3], label="predicted")
    if gt_poses is not None:
        ax.plot(gt_poses[:, 1, 3], label="groundtruth", alpha=0.8)
    ax.set_xlabel("scan")
    ax.set_ylabel("y [m]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_translation_rotation_errors(
    rel_transforms: np.ndarray,
    gt_poses: Optional[np.ndarray],
    path: str,
) -> None:
    """Per-axis relative translation and ZYX euler rotation, predicted vs GT
    (plotting.py:166-234 analog). rel_transforms: [K, 4, 4] lidar-frame
    relative transforms; gt_poses: [K+1, 4, 4] world-frame absolute poses."""
    from scipy.spatial.transform import Rotation

    from delora_tpu_torch.utils.poses import TRANSFORM_LIDAR_TO_WORLD

    rel = np.asarray(rel_transforms).reshape(-1, 4, 4)
    rows = 2
    fig, axes = plt.subplots(rows, 3, figsize=(15, 6))

    pred_t = rel[:, :3, 3]
    pred_e = Rotation.from_matrix(rel[:, :3, :3]).as_euler("ZYX")
    gt_t = gt_e = None
    if gt_poses is not None:
        L = TRANSFORM_LIDAR_TO_WORLD
        gt_lidar = np.einsum("ij,kjl,lm->kim", L.T, np.asarray(gt_poses), L)
        gt_rel = np.stack([
            np.linalg.inv(gt_lidar[k]) @ gt_lidar[k + 1]
            for k in range(len(gt_lidar) - 1)
        ])
        gt_t = gt_rel[:, :3, 3]
        gt_e = Rotation.from_matrix(gt_rel[:, :3, :3]).as_euler("ZYX")

    for i, name in enumerate("xyz"):
        axes[0, i].plot(pred_t[:, i], label="pred", linewidth=0.8)
        if gt_t is not None:
            axes[0, i].plot(gt_t[: len(pred_t), i], label="gt",
                            linewidth=0.8, alpha=0.7)
        axes[0, i].set_ylabel(f"t_{name} [m]")
        axes[0, i].legend(fontsize=7)
    for i, name in enumerate(("yaw", "pitch", "roll")):
        axes[1, i].plot(np.rad2deg(pred_e[:, i]), label="pred", linewidth=0.8)
        if gt_e is not None:
            axes[1, i].plot(np.rad2deg(gt_e[: len(pred_e), i]), label="gt",
                            linewidth=0.8, alpha=0.7)
        axes[1, i].set_ylabel(f"{name} [deg]")
        axes[1, i].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_range_image_grid(images, labels, path: str):
    """Stacked single-channel image panels (plotting.py:12-58 analog).

    images: list of [H, W] arrays (e.g. range channel, normal components,
    pointwise loss).
    """
    n = len(images)
    fig, axes = plt.subplots(n, 1, figsize=(14, 1.6 * n))
    if n == 1:
        axes = [axes]
    for ax, img, label in zip(axes, images, labels):
        ax.imshow(np.asarray(img), aspect="auto", cmap="viridis")
        ax.set_ylabel(label, fontsize=7)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_training_panels(panels, path: str, iteration: int = 0):
    """Reference 6-panel training diagnostic (plotting.py:12-58 parity):
    range images in turbo, normal maps as RGB (n+1)/2, loss map in turbo;
    zero-range pixels blacked out.

    panels: list of (label, kind, array) with kind in {"range", "normals",
    "loss"}; "range"/"loss" arrays are [H, W], "normals" are [H, W, 3].
    """
    n = len(panels)
    fig, axes = plt.subplots(n, 1, figsize=(14, 1.8 * n))
    if n == 1:
        axes = [axes]
    fig.suptitle(f"Results at iteration {iteration}", fontsize=9)
    for ax, (label, kind, img) in zip(axes, panels):
        img = np.asarray(img)
        if kind == "normals":
            mag = np.linalg.norm(img, axis=-1)
            rgb = np.clip((img + 1.0) / 2.0, 0.0, 1.0)
            rgb[mag == 0] = 0.0
            ax.imshow(rgb, aspect="auto")
        else:
            shown = ax.imshow(img, aspect="auto", cmap="turbo")
            fig.colorbar(shown, ax=ax, fraction=0.02, pad=0.01)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.text(
            1.0, 0.02, label, transform=ax.transAxes, color="w",
            ha="right", va="bottom", fontsize=7, alpha=0.7,
        )
    fig.savefig(path, dpi=120)
    plt.close(fig)
