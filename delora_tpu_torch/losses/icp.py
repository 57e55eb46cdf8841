"""Geometric scan-matching (ICP-style) self-supervised losses, mask-based.

The port of ``delora_tpu/losses/icp.py``. Every partition of the pairs is a
boolean mask over fixed-shape tensors; gradients flow through the source
points and source normals only (the targets come from a detached search).

Pair selection:
  * a point "has a normal" iff any normal component is nonzero;
  * po2pl and pl2pl use pairs where both the source point and its matched
    target have normals;
  * po2po (off by default) uses pairs where neither has a normal, or every
    matched pair under ``po2po_alone``.

Residuals, each a masked mean with denominator ``max(count, 1)``:
  * po2pl: ((s - t) . n_t)^2;
  * pl2pl "squared": ||n_s - n_t||^2; "linear": (1 - n_s . n_t)^2;
  * po2po: (s_i - t_i)^2 over the 3 coordinates of each pair.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from delora_tpu_torch.ops.correspondence import Correspondence


class IcpLossConfig(NamedTuple):
    point_to_point: bool = False
    point_to_plane: bool = True
    plane_to_plane: bool = True
    po2po_alone: bool = False          # every matched pair, po2po only
    normal_loss: str = "squared"       # "squared" | "linear"
    lambda_po2pl: float = 1.0
    lambda_pl2pl: float = 1.0
    trim_sq_distance: float = 0.0      # > 0: reject pairs with sq distance above

    @classmethod
    def from_config(cls, config):
        trim = float(config.get("po2pl_trim_distance", 0.0))
        return cls(
            point_to_point=bool(config["point_to_point_loss"]),
            point_to_plane=bool(config["point_to_plane_loss"]),
            plane_to_plane=bool(config["plane_to_plane_loss"]),
            po2po_alone=bool(config.get("po2po_alone", False)),
            normal_loss=str(config["normal_loss"]),
            lambda_po2pl=float(config["lambda_po2pl"]),
            lambda_pl2pl=float(config.get("lambda_pl2pl", 1.0)),
            trim_sq_distance=trim * trim,
        )


def masked_mse(residual_sq: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``residual_sq`` over True entries of the last axes (all but
    the first, batch, axis); 0 where the mask is empty."""
    mask_f = mask.to(residual_sq.dtype)
    dims = tuple(range(1, residual_sq.dim()))
    count = mask_f.sum(dims)
    return (residual_sq * mask_f).sum(dims) / torch.clamp(count, min=1.0)


def icp_losses(
    source_points: torch.Tensor,       # [B, S, 3] transformed source points
    source_normals: torch.Tensor,      # [B, S, 3] rotated source normals (0 = none)
    source_valid: torch.Tensor,        # [B, S] bool
    corr: Correspondence,              # match per source point, [B, S, ...]
    cfg: IcpLossConfig,
) -> Dict[str, torch.Tensor]:
    """Per-pair loss dict, each value ``[B]`` (the reference computes one
    scan pair and vmaps it over the batch)."""
    source_has_normal = (source_normals != 0.0).any(-1)
    target_has_normal = (corr.target_normals != 0.0).any(-1)
    pair_ok = source_valid & corr.valid
    if cfg.trim_sq_distance > 0.0:
        pair_ok = pair_ok & (corr.sq_dist <= cfg.trim_sq_distance)

    diff = source_points - corr.target_points
    zero = source_points.new_zeros(source_points.shape[0])

    if cfg.po2po_alone:
        loss_po2po = masked_mse(diff * diff, pair_ok[..., None].expand(diff.shape))
        return {"loss_po2po": loss_po2po, "loss_po2pl": zero, "loss_pl2pl": zero,
                "num_po2pl_pairs": pair_ok.sum(-1), "loss_pc": loss_po2po}

    both_normals = pair_ok & source_has_normal & target_has_normal
    neither_normals = pair_ok & ~source_has_normal & ~target_has_normal
    losses = {"loss_po2po": zero, "loss_po2pl": zero, "loss_pl2pl": zero,
              "num_po2pl_pairs": both_normals.sum(-1)}

    if cfg.point_to_point:
        losses["loss_po2po"] = masked_mse(
            diff * diff, neither_normals[..., None].expand(diff.shape))
    if cfg.point_to_plane:
        plane_dist = (diff * corr.target_normals).sum(-1)
        losses["loss_po2pl"] = masked_mse(plane_dist * plane_dist, both_normals)
    if cfg.plane_to_plane:
        if cfg.normal_loss == "linear":
            residual = 1.0 - (source_normals * corr.target_normals).sum(-1)
            losses["loss_pl2pl"] = masked_mse(residual * residual, both_normals)
        else:
            ndiff = source_normals - corr.target_normals
            losses["loss_pl2pl"] = masked_mse((ndiff * ndiff).sum(-1), both_normals)

    losses["loss_pc"] = (losses["loss_po2po"] + cfg.lambda_po2pl * losses["loss_po2pl"]
                         + cfg.lambda_pl2pl * losses["loss_pl2pl"])
    return losses
