"""Plain reference of DeLORA's online odometry: each scan filtered (points
with a non-finite coordinate or closer than 0.3 m dropped, the first
``max_points`` of the rest kept), projected to its range image and paired
with the previous scan's image; the network gives the pair's transform."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import geometry, model

MIN_RANGE = 0.3


def filtered(points: torch.Tensor, max_points: int) -> torch.Tensor:
    xyz = points[:, 0:3].float()
    keep = torch.isfinite(xyz).all(-1) & (torch.linalg.norm(xyz, dim=-1) >= MIN_RANGE)
    return xyz[keep][:max_points]


def relative_poses(weights, scans: Sequence[torch.Tensor], spec: geometry.Spec,
                   arch: model.Arch, max_points: int, quant: model.Quant = None,
                   block: int = 16, autocast: Optional[torch.dtype] = None,
                   channels_last: bool = False) -> np.ndarray:
    """[len(scans) - 1, 4, 4] float64: the transform of each consecutive
    pair."""
    images = [geometry.range_image(filtered(s, max_points), spec)[0] for s in scans]
    out: List[np.ndarray] = []
    with torch.no_grad():
        for i in range(0, len(images) - 1, block):
            j = min(i + block, len(images) - 1)
            T = model.pose(weights, torch.stack(images[i:j]), torch.stack(images[i + 1:j + 1]),
                           arch, quant, autocast, channels_last)
            out.append(T.double().cpu().numpy())
    return np.concatenate(out)
