"""Plain PyTorch reference of the projection and the window matcher.

- The range image (DeLORA's ``ProjectionUtils``): each point's azimuth and
  elevation give its pixel, rounded half to even; points outside the
  field of view are dropped; a pixel holds its closest point (among equal
  ranges the first), as xyz and range.
- The packed rule of the training step's re-projection: among the points of
  a pixel, the first whose range agrees with the pixel's smallest in the top
  16 bits of its float32 bits.
- The hard window matcher: for each occupied source pixel, the nearest
  occupied target pixel in a ``wv x wu`` window around it (rows beyond the
  image are empty, the azimuth wraps, offsets row-major, the first offset on
  ties).

Angles are taken in float64; everything else is float32.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch


class Spec(NamedTuple):
    height: int
    width: int
    fov_down: float          # radians
    fov_up: float
    fov_left: float
    fov_right: float

    @classmethod
    def from_config(cls, config: Dict) -> "Spec":
        block = config["block"]
        down, up = (math.radians(float(v)) for v in block["vertical_field_of_view"])
        left, right = (math.radians(float(v)) for v in config["horizontal_field_of_view"])
        return cls(int(block["vertical_cells"]), int(block["horizontal_cells"]),
                   down, up, left, right)


def pixels(points: torch.Tensor, valid: torch.Tensor, spec: Spec
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., N, 3] float32 points -> (range float32, flat pixel or -1)."""
    r = torch.linalg.norm(points, dim=-1)
    p = points.double()
    x, y, z = p.unbind(-1)
    u = (torch.atan2(y, x) - spec.fov_left) / (spec.fov_right - spec.fov_left) * (spec.width - 1)
    v = (torch.atan2(z, torch.sqrt(x * x + y * y)) - spec.fov_down) / (
        spec.fov_up - spec.fov_down) * (spec.height - 1)
    ui, vi = torch.round(u), torch.round(v)
    inside = (valid & (r > 0) & (ui >= 0) & (ui <= spec.width - 1) & (vi >= 0)
              & (vi <= spec.height - 1))
    pix = torch.where(inside, vi.long() * spec.width + ui.long(), -1)
    return r, pix


def _first_of_pixel(pix: torch.Tensor, order: torch.Tensor, hw: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Given points sorted by ``order`` with their pixels grouped, the
    (point, pixel) of the first point of each occupied pixel."""
    ps = pix[order]
    first = torch.ones_like(ps, dtype=torch.bool)
    first[1:] = ps[1:] != ps[:-1]
    first &= ps >= 0
    return order[first], ps[first]


def winners_exact(r: torch.Tensor, pix: torch.Tensor, hw: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scan: (winning point ids, their pixels), pixels ascending; the
    closest point of a pixel wins, the first among equal ranges."""
    by_range = torch.sort(r, stable=True).indices
    order = by_range[torch.sort(pix[by_range], stable=True).indices]
    return _first_of_pixel(pix, order, hw)


def winners_packed(r: torch.Tensor, pix: torch.Tensor, hw: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scan under the packed rule: the first point of a pixel among those
    whose range shares the top 16 bits of the smallest."""
    top = (r.contiguous().view(torch.int32).long() >> 16) & 0xFFFF
    key = torch.where(pix >= 0, pix * 65536 + top, -1)
    order = torch.sort(key, stable=True).indices
    return _first_of_pixel(pix, order, hw)


def range_image(points: torch.Tensor, spec: Spec) -> Tuple[torch.Tensor, torch.Tensor,
                                                            torch.Tensor]:
    """One scan ``[N, 3]`` -> (image ``[H, W, 4]`` of xyz and range,
    winning point ids in pixel order, their pixels)."""
    hw = spec.height * spec.width
    valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    r, pix = pixels(points, valid, spec)
    ids, wpix = winners_exact(r, pix, hw)
    image = torch.zeros(hw, 4, device=points.device)
    image[wpix, 0:3] = points[ids]
    image[wpix, 3] = r[ids]
    return image.reshape(spec.height, spec.width, 4), ids, wpix


def occupied(xyz: torch.Tensor) -> torch.Tensor:
    return (xyz != 0.0).any(-1)


def window_match(src: torch.Tensor, tgt_xyz: torch.Tensor, tgt_nrm: torch.Tensor,
                 window: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[B, H, W, 3]`` source xyz against the target's xyz and normals ->
    (found, matched xyz, matched normal); nothing carries gradients."""
    wv, wu = window
    B, H, W, _ = src.shape
    occ = occupied(tgt_xyz)
    best = torch.full((B, H, W), math.inf, device=src.device)
    bx = torch.zeros_like(src)
    bn = torch.zeros_like(src)
    for dv in range(-(wv // 2), wv // 2 + 1):
        lo, hi = max(0, -dv), min(H, H - dv)          # rows h with h + dv in the image
        if hi <= lo:
            continue
        for du in range(-(wu // 2), wu // 2 + 1):
            cx = torch.roll(tgt_xyz[:, lo + dv:hi + dv], -du, dims=2)
            cn = torch.roll(tgt_nrm[:, lo + dv:hi + dv], -du, dims=2)
            co = torch.roll(occ[:, lo + dv:hi + dv], -du, dims=2)
            d = cx - src[:, lo:hi]
            sq = torch.where(co, (d * d).sum(-1), math.inf)
            better = sq < best[:, lo:hi]
            best[:, lo:hi] = torch.where(better, sq, best[:, lo:hi])
            bx[:, lo:hi] = torch.where(better[..., None], cx, bx[:, lo:hi])
            bn[:, lo:hi] = torch.where(better[..., None], cn, bn[:, lo:hi])
    return torch.isfinite(best), bx, bn
