"""Spherical range-image projection with closest-point-per-pixel dedup.

The port of ``delora_tpu/ops/projection.py``'s routes: per point, azimuth
and elevation pixel coordinates, a field-of-view cull, then dense winner
placement (``ops/cuda/placement.py``).

- ``project_image`` (serving; the reference's ``project_image`` ->
  ``project_compact_exact``): per pixel the point with the smallest range
  (ties: lowest index), range appended as the last channel. The port has no
  16-bit pixel-id limit, so every H*W takes this route.
- ``project_scan_batch`` (the raw feed's brute-correspondence target): the same
  winners, with the pixel -> point map and the per-point survivor flags.
- ``project_compact_exact_batch`` (the raw feed's source, and its target under
  the image matcher): the same winners, also compacted to the front in pixel
  order.
- ``project_image_packed_batch`` (the train step's re-projection of the warped
  source): the packed 16-bit range rule of ``project_image_packed_batch``,
  with the reference's count of overflowing placement tiles.

Each takes one placement launch. The reference reaches the same winners
through two or three stable sorts; the exact rule of the placement kernel is
their rule, so the images, maps and compacted rows are bit-equal to it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from delora_tpu_torch.ops.cuda.placement import placement
from delora_tpu_torch.ops.exact import fma_exact


class ProjectionSpec(NamedTuple):
    """Static projection geometry for one sensor/dataset (radians)."""

    height: int                 # vertical_cells
    width: int                  # horizontal_cells
    fov_up: float
    fov_down: float
    fov_left: float             # horizontal FoV lower bound (~ -pi)
    fov_right: float            # horizontal FoV upper bound (~ +pi)

    @classmethod
    def from_config(cls, config, dataset: str = "kitti", preprocessing: bool = False):
        """The train-time geometry, or with ``preprocessing`` the offline
        normal-estimation width (``horizontal_cells_preprocessing``)."""
        spec = config[dataset]
        width_key = "horizontal_cells_preprocessing" if preprocessing else "horizontal_cells"
        return cls(
            height=int(spec["vertical_cells"]),
            width=int(spec[width_key]),
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


def _horizontal_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # x*x + y*y as the reference computes it: the compiler contracts it into
    # fma(x, x, y*y), one rounding, which fma_exact reproduces. (A float64 sum
    # rounded to f32 rounds twice where x*x + f32(y*y) lies within half a
    # float64 ulp above or below a float32 midpoint.)
    return fma_exact(x, x, y * y)


def _horizontal_norm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # The f64 sqrt of the f32 sum, rounded to f32, is the correctly rounded
    # f32 sqrt.
    return _horizontal_sq(x, y).double().sqrt().float()


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


class Projection(NamedTuple):
    """Result of :func:`project_scan_batch` (leading batch axis on every
    field).

    image:       [B, H, W, C+1] every channel of the winner + its range.
    survivor:    [B, N] bool: the point won its pixel.
    point_index: [B, H, W] int32: index of the pixel's winner, -1 if empty.
    u, v:        [B, N] unrounded pixel coordinates.
    in_fov:      [B, N] bool: valid, range > 0 and inside the field of view.
    """

    image: torch.Tensor
    survivor: torch.Tensor
    point_index: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    in_fov: torch.Tensor


def project_scan_batch(points: torch.Tensor, valid: torch.Tensor,
                       spec: ProjectionSpec) -> Projection:
    """The reference's ``vmap(project_scan)`` over ``[B, N, C>=3]`` points and
    ``[B, N]`` masks. Each point's index rides the placement as one more
    float32 payload channel (exact below 2**24 points); a pixel is occupied
    where its winner's range, always > 0, is."""
    B, N, C = points.shape
    if N >= 1 << 24:
        raise ValueError(f"project_scan_batch carries point indices in float32: N < 2**24, "
                         f"got {N}")
    points = points.to(torch.float32)
    r, u, v, in_fov, pix = _pixel_coords(points, valid, spec)
    ids = torch.arange(N, dtype=torch.float32, device=points.device).expand(B, N)
    placed = placement(pix.contiguous(), r.contiguous(),
                       torch.cat([points, ids[..., None]], dim=-1).contiguous(),
                       spec.height, spec.width)
    occupied = placed[..., C + 1] > 0.0
    point_index = torch.where(occupied, placed[..., C].to(torch.int32), -1)
    dest = torch.where(occupied, point_index, N).reshape(B, -1).to(torch.int64)
    survivor = torch.zeros(B, N + 1, dtype=torch.bool, device=points.device)
    survivor.scatter_(1, dest, True)
    image = torch.cat([placed[..., :C], placed[..., C + 1:]], dim=-1)
    return Projection(image, survivor[:, :N].contiguous(), point_index, u, v, in_fov)


def gather_image_attribute(attr: torch.Tensor, point_index: torch.Tensor) -> torch.Tensor:
    """Per-point attribute ``[B, N, C]`` -> per-pixel image ``[B, H, W, C]``
    through ``point_index`` ``[B, H, W]``; empty pixels (-1) get zeros, the
    "no normal" sentinel."""
    B, H, W = point_index.shape
    flat = point_index.reshape(B, H * W, 1).to(torch.int64)
    gathered = torch.gather(attr, 1, flat.clamp(min=0).expand(-1, -1, attr.shape[-1]))
    return torch.where(flat >= 0, gathered, 0.0).reshape(B, H, W, attr.shape[-1])


class CompactImageProjection(NamedTuple):
    """Result of :func:`project_compact_exact_batch`.

    image:     [B, H, W, C+1] payload channels + the winner's range.
    comp_vals: [B, cap, C+1] the winners' (payload..., range), pixel-ascending,
               front-compacted, cap = min(N, H*W); rows past the winner count
               are zero (the reference leaves junk there: mask with
               ``comp_mask``).
    comp_mask: [B, cap] bool: the slot holds a winner.
    """

    image: torch.Tensor
    comp_vals: torch.Tensor
    comp_mask: torch.Tensor


def project_compact_exact_batch(points: torch.Tensor, valid: torch.Tensor,
                                spec: ProjectionSpec, values: torch.Tensor = None
                                ) -> CompactImageProjection:
    """The reference's ``project_compact_exact_batch``: ``[B, N, 3]`` points,
    ``[B, N]`` masks, payload ``values`` ``[B, N, C]`` (else the points). The
    winners are the image's occupied pixels, so reading them in pixel order
    gives the reference's compaction order (its second stable sort)."""
    B, N, _ = points.shape
    points = points.to(torch.float32)
    feat = (points if values is None else values).to(torch.float32).contiguous()
    r, _, _, _, pix = _pixel_coords(points, valid, spec)
    image = placement(pix.contiguous(), r.contiguous(), feat, spec.height, spec.width)
    cap = min(N, spec.height * spec.width)
    C1 = image.shape[-1]
    flat = image.reshape(B, -1, C1)
    occupied = flat[..., -1] > 0.0
    dest = torch.where(occupied, torch.cumsum(occupied, dim=1) - 1, cap)
    comp = torch.zeros(B, cap + 1, C1, dtype=torch.float32, device=points.device)
    comp.scatter_(1, dest[..., None].expand(-1, -1, C1), flat)
    comp_mask = torch.arange(cap, device=points.device) < occupied.sum(1, keepdim=True)
    return CompactImageProjection(image, comp[:, :cap], comp_mask)


def project_image_batch(points: torch.Tensor, valid: torch.Tensor,
                        spec: ProjectionSpec) -> torch.Tensor:
    """Image-only projection, batched: ``[B, N, C>=3]`` points, ``[B, N]``
    bool -> ``[B, H, W, C+1]`` float32; each pixel holds its closest point's
    channels and range, zeros if empty (the reference's ``vmap`` of
    ``project_image``)."""
    points = points.to(torch.float32).contiguous()
    r, _, _, _, pix = _pixel_coords(points, valid, spec)
    return placement(pix.contiguous(), r.contiguous(), points, spec.height, spec.width)


def project_image(points: torch.Tensor, valid: torch.Tensor,
                  spec: ProjectionSpec) -> torch.Tensor:
    """Image-only projection of one scan: ``[N, C>=3]`` points, ``[N]`` bool
    -> ``[H, W, C+1]``."""
    return project_image_batch(points[None], valid[None], spec)[0]


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
