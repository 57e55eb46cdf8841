"""Correspondence search of the train step: the image-space window matcher
(hard or soft), its index-only reverse search, and brute-force exact 1-NN.

The port of ``delora_tpu/ops/correspondence.py``'s ``Correspondence``,
``image_space_correspondence_core`` and ``image_space_correspondence_batch``
(hard and soft matching), ``window_match_indices`` and
``brute_force_correspondence``.

Image space: the warped source is already a range image, so each source pixel
is matched against a window of the target image (``ops/cuda/window_match.py``:
the CUDA kernels on the card, their plain versions on the CPU). Hard matching
takes the nearest candidate; soft matching (``soft_sigma > 0``) blends the
window's candidates with weights exp(-sq / sigma^2), unnormalised, and a window
whose weights all underflow (sum < 1e-30) is a miss.

Brute force: the exact 1-NN of every source point among the valid target
points (``ops/cuda/nn_search.py``).

Every search sees a detached copy of the source, as the reference's (which
detaches its KD indices, reference icp_losses.py:64-67); the matched target
point and normal are masked by the validity and the squared distance is
recomputed from the live source, so gradients reach the source points through
``sq_dist`` and the losses.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from delora_tpu_torch.ops.cuda.nn_search import nn_search
from delora_tpu_torch.ops.cuda.window_match import (
    window_match,
    window_match_indices as _match_indices,
    window_match_soft,
)
from delora_tpu_torch.ops.projection import ProjectionSpec


class Correspondence(NamedTuple):
    """Per-source-point match against the target scan.

    target_points:  [..., S, 3] matched target point (zeros if invalid)
    target_normals: [..., S, 3] matched target normal (zeros = no normal)
    valid:          [..., S] bool: a target point was found
    sq_dist:        [..., S] squared distance to the match (inf if invalid)
    """

    target_points: torch.Tensor
    target_normals: torch.Tensor
    valid: torch.Tensor
    sq_dist: torch.Tensor


def _masked(src_pts, valid, best_xyz, best_nrm) -> Correspondence:
    """The match masked by ``valid``, with the distance recomputed from the
    live source."""
    mask = valid[..., None]
    tgt_pts = torch.where(mask, best_xyz, 0.0)
    tgt_nrm = torch.where(mask, best_nrm, 0.0)
    dd = src_pts - tgt_pts
    sq_out = torch.where(valid, (dd * dd).sum(-1), float("inf"))
    return Correspondence(tgt_pts, tgt_nrm, valid, sq_out)


def image_space_correspondence_batch(
    src_xyz: torch.Tensor,               # [B, H*W, 3] per-pixel source points
    src_occ: torch.Tensor,               # [B, H*W] bool: pixel holds a point
    target_image: torch.Tensor,          # [B, H, W, >=3] projected target
    target_normal_image: torch.Tensor,   # [B, H, W, 3]
    spec: ProjectionSpec,
    window: Tuple[int, int] = (5, 9),
    soft_sigma: float = 0.0,
) -> Correspondence:
    """Window matching of every source pixel, hard or (``soft_sigma > 0``)
    soft (see the module docstring). ``src_xyz`` may carry gradients and may
    be a channel slice of a wider channels-last image; the kernels read it in
    place."""
    B = src_xyz.shape[0]
    H, W = spec.height, spec.width
    args = (src_xyz.detach().reshape(B, H, W, 3), target_image.detach()[..., 0:3],
            target_normal_image.detach(), tuple(window))
    if soft_sigma > 0.0:
        best_sq, best_xyz, best_nrm = window_match_soft(*args, soft_sigma)
    else:
        best_sq, best_xyz, best_nrm = window_match(*args)
    valid = src_occ & torch.isfinite(best_sq.reshape(B, H * W))
    return _masked(src_xyz, valid, best_xyz.reshape(B, H * W, 3),
                   best_nrm.reshape(B, H * W, 3))


def image_space_correspondence_core(
    src_xyz: torch.Tensor,               # [H*W, 3]
    src_occ: torch.Tensor,               # [H*W] bool
    target_image: torch.Tensor,          # [H, W, >=3]
    target_normal_image: torch.Tensor,   # [H, W, 3]
    spec: ProjectionSpec,
    window: Tuple[int, int] = (5, 9),
    soft_sigma: float = 0.0,
) -> Correspondence:
    """:func:`image_space_correspondence_batch` for one scan."""
    corr = image_space_correspondence_batch(
        src_xyz[None], src_occ[None], target_image[None], target_normal_image[None],
        spec, window, soft_sigma)
    return Correspondence(*(x[0] for x in corr))


def window_match_indices(
    src_xyz: torch.Tensor,               # [B, H*W, 3] query points (per pixel)
    src_occ: torch.Tensor,               # [B, H*W] bool
    cand_xyz_image: torch.Tensor,        # [B, H, W, 3] candidate points
    cand_occ_image: torch.Tensor,        # [B, H, W] float32: occupied where > 0.5
    spec: ProjectionSpec,
    window: Tuple[int, int] = (5, 9),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hard window match returning the winning offset index, not values:
    ``(best_k [B, H*W] int32, best_sq [B, H*W], valid [B, H*W])`` with
    ``best_k = dv * wu + du_idx`` (0 where nothing matched) and
    ``valid = src_occ & isfinite(best_sq)``. The winner's pixel is
    ``ops/cuda/window_match.py::winner_pixel``. Nothing carries gradients."""
    B = src_xyz.shape[0]
    H, W = spec.height, spec.width
    best_k, best_sq = _match_indices(src_xyz.detach().reshape(B, H, W, 3),
                                     cand_xyz_image.detach(), cand_occ_image.detach(),
                                     tuple(window))
    best_sq = best_sq.reshape(B, H * W)
    return best_k.reshape(B, H * W), best_sq, src_occ & torch.isfinite(best_sq)


def brute_force_correspondence(
    source_points: torch.Tensor,      # [B, S, 3]
    source_valid: torch.Tensor,       # [B, S]
    target_points: torch.Tensor,      # [B, T, 3]
    target_valid: torch.Tensor,       # [B, T]
    target_normals: torch.Tensor,     # [B, T, 3]
) -> Correspondence:
    """Exact 1-NN of every source point among the valid target points of its
    batch. ``valid = source_valid & any(target_valid) & isfinite(sq)``; the
    winner's point and normal are masked by it and the squared distance is
    recomputed from the live source."""
    idx, sq = nn_search(source_points.detach().contiguous(),
                        target_points.detach().contiguous(), target_valid.contiguous())
    valid = source_valid & target_valid.any(-1, keepdim=True) & torch.isfinite(sq)
    gather = idx.to(torch.int64)[..., None].expand(-1, -1, 3)
    return _masked(source_points, valid, torch.gather(target_points.detach(), 1, gather),
                   torch.gather(target_normals.detach(), 1, gather))
