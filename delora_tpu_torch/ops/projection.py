"""Spherical range-image projection with closest-point-per-pixel dedup.

The port of ``delora_tpu/ops/projection.py``'s image-only routes: per point,
azimuth and elevation pixel coordinates, a field-of-view cull, then dense
winner placement (``ops/cuda/placement.py``).

- ``project_image`` (serving; the reference's ``project_image`` ->
  ``project_compact_exact``): per pixel the point with the smallest range
  (ties: lowest index), range appended as the last channel. The port has no
  16-bit pixel-id limit, so every H*W takes this route.
- ``project_image_packed_batch`` (the train step's re-projection of the warped
  source): the packed 16-bit range rule of ``project_image_packed_batch``,
  with the reference's count of overflowing placement tiles.
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


# The reference's XLA placement works in 1024-pixel tiles, each reading a
# window of at most 3072 sorted entries (projection.py:248-360).
_TILE = 1024
_TILE_ENTRIES = 3072


def project_image_packed_batch(points: torch.Tensor, valid: torch.Tensor,
                               spec: ProjectionSpec, values: torch.Tensor = None,
                               return_overflow: bool = False, append_range: bool = True):
    """Image-only projection under the packed winner rule, batched:
    ``[B, N, 3]`` points, ``[B, N]`` bool -> ``[B, H, W, C]`` float32, where
    the payload is ``values`` ``[B, N, C']`` (else the points) and
    C = C' + ``append_range``. Pixel and range keys always come from
    ``points``.

    Winner rule: the reference's stable sort on
    ``pix << 16 | f32_bits(range) >> 16`` (projection.py:319-322), i.e. the
    lowest index among the points whose ranges agree with the pixel's
    smallest in the top 16 bits.

    ``return_overflow`` also returns ``[B]`` int32 counts of overflowing
    placement tiles, by the rule of the reference's XLA route
    (projection.py:350-359): a 1024-pixel tile overflows when more than
    ``min(3072, N)`` in-FoV entries land in it. (The reference's Pallas route
    counts against ``nchunks * 512`` chunk-aligned entries instead,
    :576-582, so the two reference routes can disagree on the count.) The
    port never drops a winner, whereas the reference's XLA route empties the
    tail of an overflowing tile: the two images agree where the count is 0.

    Requires H*W < 65536, as the reference does; the train step takes the
    exact rule beyond that, as the reference's does (step.py:277, :288-291).
    """
    H, W = spec.height, spec.width
    if H * W >= (1 << 16):
        raise ValueError(f"project_image_packed_batch needs H*W < 65536, got {H * W}")
    points = points.to(torch.float32)
    feat = (points if values is None else values).to(torch.float32).contiguous()
    r, _, _, in_fov, pix = _pixel_coords(points, valid, spec)
    image = placement(pix.contiguous(), r.contiguous(), feat, H, W, packed=True,
                      append_range=append_range)
    if not return_overflow:
        return image
    B, N = pix.shape
    n_tiles = -(-H * W // _TILE)
    tile = torch.where(in_fov, pix // _TILE, n_tiles).to(torch.int64)
    counts = torch.zeros(B, n_tiles + 1, dtype=torch.int32, device=pix.device)
    counts.scatter_add_(1, tile, torch.ones_like(tile, dtype=torch.int32))
    overflow = (counts[:, :n_tiles] > min(_TILE_ENTRIES, N)).sum(-1, dtype=torch.int32)
    return image, overflow
