"""Image-space correspondence: the train step's matcher, hard branch.

The port of ``delora_tpu/ops/correspondence.py``'s ``Correspondence``,
``image_space_correspondence_core`` and ``image_space_correspondence_batch``
(hard matching). The warped source is already a range image, so each source
pixel is matched against a window of the target image
(``ops/cuda/window_match.py``: the CUDA kernel on the card, its plain version
on the CPU). The search sees a detached copy of the source, as the reference's
(which detaches its KD indices, reference icp_losses.py:64-67); the matched
target point and normal are masked by ``valid = src_occ & isfinite(best_sq)``
and the squared distance is recomputed from the live source, so gradients
reach the source points through ``sq_dist`` and the losses.

Soft matching (``soft_sigma > 0``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from delora_tpu_torch.ops.cuda.window_match import window_match
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


def image_space_correspondence_batch(
    src_xyz: torch.Tensor,               # [B, H*W, 3] per-pixel source points
    src_occ: torch.Tensor,               # [B, H*W] bool: pixel holds a point
    target_image: torch.Tensor,          # [B, H, W, >=3] projected target
    target_normal_image: torch.Tensor,   # [B, H, W, 3]
    spec: ProjectionSpec,
    window: Tuple[int, int] = (5, 9),
    soft_sigma: float = 0.0,
) -> Correspondence:
    """Hard window matching of every source pixel (see the module docstring).
    ``src_xyz`` may carry gradients and may be a channel slice of a wider
    channels-last image; the kernel reads it in place."""
    if soft_sigma > 0.0:
        raise NotImplementedError("soft window matching (soft_sigma > 0) is not ported yet")
    B = src_xyz.shape[0]
    H, W = spec.height, spec.width
    best_sq, best_xyz, best_nrm = window_match(
        src_xyz.detach().reshape(B, H, W, 3), target_image.detach()[..., 0:3],
        target_normal_image.detach(), tuple(window))
    valid = src_occ & torch.isfinite(best_sq.reshape(B, H * W))
    mask = valid[..., None]
    tgt_pts = torch.where(mask, best_xyz.reshape(B, H * W, 3), 0.0)
    tgt_nrm = torch.where(mask, best_nrm.reshape(B, H * W, 3), 0.0)
    dd = src_xyz - tgt_pts
    sq_out = torch.where(valid, (dd * dd).sum(-1), float("inf"))
    return Correspondence(tgt_pts, tgt_nrm, valid, sq_out)


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
