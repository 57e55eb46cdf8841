"""Host-side (numpy) spherical projection: the per-scan artifacts of the
fully-cached training feed.

A copy of ``delora_tpu/ops/projection_host.py``'s numpy route
(``project_scan_np``, ``ScanArtifacts``, ``scan_artifacts_np`` without the
native C++ projection, which comes with the host-feed slice). A scan's
target-side artifacts (the ``[H, W, 4]`` xyz+range image, the ``[H, W, 3]``
normal image, the mean range) and its source-side artifacts (the compacted
surviving points and normals) depend on the scan alone, so the trainer
computes them once per scan and keeps them on the device.

Winner rule: per pixel the point with the smallest range, and among equal
ranges the lowest index (``np.lexsort`` is stable). The arithmetic is numpy
float32, as in the reference module, so the artifacts are bit-equal to it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from delora_tpu_torch.ops.projection import ProjectionSpec


class HostProjection(NamedTuple):
    image: np.ndarray          # [H, W, C+1] float32: channels + range
    point_index: np.ndarray    # [H, W] int32: winning point id, -1 if empty
    mean_range: float          # mean range over valid points (normalization)


def project_scan_np(points: np.ndarray, valid: np.ndarray,
                    spec: ProjectionSpec) -> HostProjection:
    """Project one padded scan ``[N, C>=3]`` with validity mask ``[N]``."""
    points = np.asarray(points, np.float32)
    valid = np.asarray(valid, bool)
    H, W = spec.height, spec.width
    num_pix = H * W

    xyz = points[:, :3]
    r = np.linalg.norm(xyz, axis=-1)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    u = (np.arctan2(y, x) - spec.fov_left) / (spec.fov_right - spec.fov_left) * (W - 1)
    v = (np.arctan2(z, np.sqrt(x * x + y * y)) - spec.fov_down) / (
        spec.fov_up - spec.fov_down) * (H - 1)
    ui = np.round(u)
    vi = np.round(v)
    in_fov = valid & (r > 0) & (ui >= 0) & (ui <= W - 1) & (vi >= 0) & (vi <= H - 1)
    pix = np.where(
        in_fov,
        np.clip(vi, 0, H - 1).astype(np.int64) * W + np.clip(ui, 0, W - 1).astype(np.int64),
        num_pix,
    )

    # Stable sort by (pixel, range): the first of each pixel's run is its
    # closest point; equal ranges go to the smallest id.
    order = np.lexsort((r, pix))
    sorted_pix = pix[order]
    first = np.empty(len(order), bool)
    first[0] = True
    first[1:] = sorted_pix[1:] != sorted_pix[:-1]
    winner_slots = first & (sorted_pix < num_pix)
    win_ids = order[winner_slots]
    win_pix = sorted_pix[winner_slots]

    feat = np.concatenate([points, r[:, None]], axis=-1)
    image = np.zeros((num_pix, feat.shape[-1]), np.float32)
    image[win_pix] = feat[win_ids]
    point_index = np.full(num_pix, -1, np.int32)
    point_index[win_pix] = win_ids.astype(np.int32)

    nvalid = max(int(valid.sum()), 1)
    mean_range = float((r * valid).sum() / nvalid)
    return HostProjection(image=image.reshape(H, W, feat.shape[-1]),
                          point_index=point_index.reshape(H, W),
                          mean_range=mean_range)


class ScanArtifacts(NamedTuple):
    """Everything the fully-cached train step needs from one scan, for both
    of its roles (target of pair k, source of pair k-1).

    image:        [H, W, 4] float32: xyz + range (zeros at empty pixels).
    normal_image: [H, W, 3] float32: zero = no normal.
    mean_range:   float, over the valid raw points (pair normalization).
    src_points:   [cap, 3] float32: surviving points, pixel-ascending.
    src_normals:  [cap, 3] float32: their normals, zero-padded.
    src_valid:    [cap] bool: slot holds a real survivor.
    cap = min(N, H*W).
    """

    image: np.ndarray
    normal_image: np.ndarray
    mean_range: float
    src_points: np.ndarray
    src_normals: np.ndarray
    src_valid: np.ndarray


def scan_artifacts_np(points: np.ndarray, normals: np.ndarray, valid: np.ndarray,
                      spec: ProjectionSpec) -> ScanArtifacts:
    """Per-scan projection artifacts for both pair roles (see ScanArtifacts).
    Survivors come in pixel order: ``point_index`` raveled."""
    proj = project_scan_np(points, valid, spec)
    pi = proj.point_index
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    normal_image = np.where((pi >= 0)[..., None], normals[np.clip(pi, 0, None)],
                            0.0).astype(np.float32)
    cap = min(points.shape[0], spec.height * spec.width)

    sel = pi.ravel()
    sel = sel[sel >= 0]
    k = len(sel)
    src_points = np.zeros((cap, 3), np.float32)
    src_normals = np.zeros((cap, 3), np.float32)
    src_valid = np.zeros(cap, bool)
    src_points[:k] = points[sel, :3]
    src_normals[:k] = normals[sel, :3]
    src_valid[:k] = True
    return ScanArtifacts(image=proj.image, normal_image=normal_image,
                         mean_range=proj.mean_range, src_points=src_points,
                         src_normals=src_normals, src_valid=src_valid)
