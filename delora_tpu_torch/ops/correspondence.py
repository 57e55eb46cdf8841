"""Correspondence search of the train step: the image-space window matcher
(hard or soft), its index-only reverse search, and brute-force exact 1-NN.

The port of ``delora_tpu/ops/correspondence.py``'s ``Correspondence``,
``image_space_correspondence_core`` and ``image_space_correspondence_batch``
(hard and soft matching), ``window_match_indices``,
``projective_correspondence`` and ``brute_force_correspondence``.

Image space: the warped source is already a range image, so each source pixel
is matched against a window of the target image (``ops/cuda/window_match.py``:
the CUDA kernels on the card, their plain versions on the CPU). Hard matching
takes the nearest candidate; soft matching (``soft_sigma > 0``) blends the
window's candidates with weights exp(-sq / sigma^2), unnormalised, and a window
whose weights all underflow (sum < 1e-30) is a miss.

Projective: each warped source point is projected into the target image and
matched against the (wv, wu) window of target pixels around its pixel,
azimuth wrapping and elevation clamped. Candidates are ranked on their xyz
rounded to bfloat16, as the reference ranks them; the winner's exact float32
point and normal are gathered afterwards. PyTorch ops, no kernel: the
reference runs it in XLA.

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
from delora_tpu_torch.ops.exact import squared_distance
from delora_tpu_torch.ops.projection import ProjectionSpec, compute_uv


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


def projective_correspondence(
    source_points: torch.Tensor,         # [B, S, 3] warped source points
    source_valid: torch.Tensor,          # [B, S] bool
    target_image: torch.Tensor,          # [B, H, W, >=3] projected target
    target_normal_image: torch.Tensor,   # [B, H, W, 3]
    spec: ProjectionSpec,
    window: Tuple[int, int] = (5, 9),
) -> Correspondence:
    """Projective data association (see the module docstring). A point's
    pixel is its rounded (u, v) clamped into the image; the K = wv * wu
    candidates are ranked by fma-formed squared distance to their bfloat16
    xyz (float32 arithmetic), empty pixels at +inf, the first offset on ties
    and offset 0 when all are empty. ``valid`` = the winning pixel is
    occupied and the source point valid."""
    B, S, _ = source_points.shape
    H, W = spec.height, spec.width
    wv, wu = window
    a, b = wv // 2, wu // 2
    src = source_points.detach()
    u, v = compute_uv(src, spec)
    ui = torch.round(u).to(torch.int64).clamp(0, W - 1)
    vi = torch.round(v).to(torch.int64).clamp(0, H - 1)

    xyz = target_image.detach()[..., 0:3]
    occ = (xyz != 0.0).any(-1, keepdim=True).to(xyz.dtype)
    # Four bfloat16 channels (xyz, occupancy) are one 8-byte word a pixel:
    # each candidate is one int64 gather.
    table = torch.cat([xyz, occ], dim=-1).to(torch.bfloat16).contiguous()
    table = table.view(torch.int64).reshape(B, H * W)
    dv = torch.arange(-a, a + 1, device=src.device).repeat_interleave(wu)
    du = torch.arange(-b, b + 1, device=src.device).repeat(wv)
    rows = (vi[..., None] + dv).clamp(0, H - 1)
    cols = torch.remainder(ui[..., None] + du, W)
    cand_pix = (rows * W + cols).reshape(B, S * len(dv))
    cand = torch.gather(table, 1, cand_pix).view(torch.bfloat16).reshape(B, S, len(dv), 4)
    cand = cand.to(torch.float32)
    sq = squared_distance(cand[..., 0:3] - src[:, :, None, :])
    sq = torch.where(cand[..., 3] > 0.5, sq, float("inf"))
    best_k = torch.argmin(sq, dim=-1, keepdim=True)

    win_pix = torch.gather(cand_pix.reshape(B, S, -1), 2, best_k)
    flat = torch.cat([xyz, target_normal_image.detach(), occ], dim=-1).reshape(B, H * W, 7)
    best = torch.gather(flat, 1, win_pix.expand(-1, -1, 7))
    valid = (best[..., 6] > 0.5) & source_valid
    return _masked(source_points, valid, best[..., 0:3], best[..., 3:6])


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
