"""Spherical range-image projection with closest-point-per-pixel dedup.

The port of ``delora_tpu/ops/projection.py``'s image-only route
(``project_image`` -> ``project_compact_exact``): per point, azimuth and
elevation pixel coordinates, a field-of-view cull, then dense winner placement
(``ops/cuda/placement.py``), which keeps per pixel the point with the smallest
range (ties: lowest index) and appends the range as the last channel. The port
has no 16-bit pixel-id limit, so every H*W takes this route.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from delora_tpu_torch.ops.cuda.placement import placement


class ProjectionSpec(NamedTuple):
    """Static projection geometry for one sensor/dataset (radians)."""

    height: int                 # vertical_cells
    width: int                  # horizontal_cells
    fov_up: float
    fov_down: float
    fov_left: float             # horizontal FoV lower bound (~ -pi)
    fov_right: float            # horizontal FoV upper bound (~ +pi)

    @classmethod
    def from_config(cls, config, dataset: str = "kitti"):
        spec = config[dataset]
        return cls(
            height=int(spec["vertical_cells"]),
            width=int(spec["horizontal_cells"]),
            fov_down=float(spec["vertical_field_of_view"][0]),
            fov_up=float(spec["vertical_field_of_view"][1]),
            fov_left=float(config["horizontal_field_of_view"][0]),
            fov_right=float(config["horizontal_field_of_view"][1]),
        )


def _scale(span: float, cells: int) -> float:
    # The reference writes ``(a - lo) / span * (cells - 1)``; XLA compiles the
    # division by a constant into a product with its f32 reciprocal and folds
    # the two constants into one f32 factor. The port multiplies by that same
    # factor, so the pixel coordinates agree bit for bit.
    return float(np.float32(np.float32(1.0) / np.float32(span)) * np.float32(cells))


def _horizontal_norm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # sqrt(x*x + y*y) as the reference computes it: the compiler contracts it
    # into fma(x, x, y*y), one rounding. x*x is exact in float64, so the f64
    # sum rounded to f32 is the fused result (but for double-rounding cases,
    # about one input in 2**29); the f64 sqrt rounded to f32 is the correctly
    # rounded f32 sqrt.
    xy = (x.double() * x.double() + (y * y).double()).float()
    return xy.double().sqrt().float()


def compute_uv(points: torch.Tensor, spec: ProjectionSpec):
    """Unrounded azimuth/elevation pixel coordinates of ``[..., 3]`` points."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    u = (torch.atan2(y, x) - spec.fov_left) * _scale(
        spec.fov_right - spec.fov_left, spec.width - 1)
    v = (torch.atan2(z, _horizontal_norm(x, y)) - spec.fov_down) * _scale(
        spec.fov_up - spec.fov_down, spec.height - 1)
    return u, v


def _pixel_coords(points: torch.Tensor, valid: torch.Tensor, spec: ProjectionSpec):
    """-> (range, u, v, in_fov, pix) over ``[..., N]``; culled points get the
    sentinel pixel id H*W. Rounding is half to even, as ``jnp.round``."""
    H, W = spec.height, spec.width
    # torch.linalg.norm matches jnp.linalg.norm bit for bit; an explicit
    # sqrt(x*x + y*y + z*z) does not, and would move near-tie winners.
    r = torch.linalg.norm(points[..., :3], dim=-1)
    u, v = compute_uv(points[..., :3], spec)
    ui = torch.round(u)
    vi = torch.round(v)
    in_fov = valid & (r > 0) & (ui >= 0) & (ui <= W - 1) & (vi >= 0) & (vi <= H - 1)
    ui = ui.to(torch.int32).clamp(0, W - 1)
    vi = vi.to(torch.int32).clamp(0, H - 1)
    pix = torch.where(in_fov, vi * W + ui, H * W).to(torch.int32)
    return r, u, v, in_fov, pix


def project_image(points: torch.Tensor, valid: torch.Tensor,
                  spec: ProjectionSpec) -> torch.Tensor:
    """Image-only projection of one scan: ``[N, C>=3]`` points, ``[N]`` bool
    -> ``[H, W, C+1]`` float32; each pixel holds its closest point's channels
    and range, zeros if empty."""
    points = points.to(torch.float32).contiguous()
    r, _, _, _, pix = _pixel_coords(points, valid, spec)
    return placement(pix[None], r[None], points[None], spec.height, spec.width)[0]
