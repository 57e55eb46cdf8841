"""The training step of the fully-cached main path, and the model forward to
SE(3) transforms that serving shares.

The port of ``delora_tpu/training/step.py``'s ``forward_pose``,
``StepConfig``, ``FullyCachedBatch``, ``_loss_tail`` (image-space matcher,
hard matching), ``loss_and_metrics_fullcached`` (augmentation off) and
``optax_global_norm``, with ``train_step`` in place of the jitted
``make_train_step_fullcached``. One step:

  1. model forward on the cached range images -> T [B, 4, 4];
  2. the compacted source points warped by the DETACHED T and re-projected
     under the packed winner rule (``project_image_packed_batch``: the
     placement kernel), storing each winner's original xyz, normal and a
     constant 1 (occupancy, and the homogeneous coordinate of step 3);
  3. one per-pixel 7x7 affine ``s_all = wimage @ A(T)^T`` re-applies the warp
     with gradient: the only gradient path to T, elementwise;
  4. hard window matching of s_all's xyz against the target image (the
     window matcher kernel), on a detached copy;
  5. the ICP losses, the supervised identity loss, the metrics.

Neither kernel needs a backward: both see only detached inputs, as the TPU
kernels see only stop-gradient inputs in the reference. Parameters, losses and
the optimizer stay float32; ``compute_dtype: bfloat16`` is autocast around the
model only.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from delora_tpu_torch import se3
from delora_tpu_torch.config import validate
from delora_tpu_torch.losses.icp import IcpLossConfig, icp_losses
from delora_tpu_torch.ops.correspondence import image_space_correspondence_batch
from delora_tpu_torch.ops.cuda.placement import placement
from delora_tpu_torch.ops.projection import (
    ProjectionSpec,
    _pixel_coords,
    compute_uv,
    project_image_packed_batch,
)


def forward_pose(model, image_1: torch.Tensor, image_2: torch.Tensor,
                 quat_also: bool = False):
    """Model forward on ``[B, H, W, C]`` image pairs -> ``[B, 4, 4]``
    transforms (and the raw translation and quaternion if ``quat_also``)."""
    translation, quat = model(image_1, image_2)
    T = se3.transform_from_quat(translation, quat)
    if quat_also:
        return T, translation, quat
    return T


class StepConfig(NamedTuple):
    """What the step reads of the config, for one dataset and phase."""

    proj: ProjectionSpec
    icp: IcpLossConfig
    window: Tuple[int, int] = (5, 9)
    supervised: bool = False                  # identity-fit warmup phase
    normalization_scaling: bool = False

    @classmethod
    def from_config(cls, config, dataset: str = "kitti", *, supervised: bool):
        validate(config)
        return cls(
            proj=ProjectionSpec.from_config(config, dataset),
            icp=IcpLossConfig.from_config(config),
            window=tuple(int(w) for w in config["projective_window"]),
            supervised=supervised,
            normalization_scaling=bool(config["normalization_scaling"]),
        )


class FullyCachedBatch(NamedTuple):
    """A batch whose both scans' projection artifacts are precomputed
    (``ops/projection_host.py::scan_artifacts_np``).

    image_1:        [B, H, W, 4] target xyz + range (zeros at empty pixels).
    normal_image_1: [B, H, W, 3] target normals (zero = no normal).
    mean_range_1:   [B] target mean range (pair normalization).
    image_2:        [B, H, W, 4] source range image (model input).
    src_points:     [B, cap, 3] compacted surviving source points.
    src_normals:    [B, cap, 3] their normals (zeros = no normal).
    src_valid:      [B, cap] bool.
    mean_range_2:   [B] source mean range.
    """

    image_1: torch.Tensor
    normal_image_1: torch.Tensor
    mean_range_1: torch.Tensor
    image_2: torch.Tensor
    src_points: torch.Tensor
    src_normals: torch.Tensor
    src_valid: torch.Tensor
    mean_range_2: torch.Tensor


def _warped_image(pos_sel, src_valid, vals, spec: ProjectionSpec):
    """Re-projection of the warped source -> ([B, H, W, 7] image of ``vals``,
    overflowing placement tiles summed over the batch as float32). The packed
    rule below 65536 pixels, the exact rule above, as the reference
    (step.py:277-291)."""
    H, W = spec.height, spec.width
    if H * W < (1 << 16):
        wimage, n_overflow = project_image_packed_batch(
            pos_sel, src_valid, spec, values=vals, return_overflow=True, append_range=False)
        return wimage, n_overflow.sum().to(torch.float32)
    r, _, _, _, pix = _pixel_coords(pos_sel, src_valid, spec)
    wimage = placement(pix.contiguous(), r.contiguous(), vals.contiguous(), H, W,
                       append_range=False)
    return wimage, pos_sel.new_zeros(())


def _loss_tail(model, image_1, target_normal_image, image_2, pts_c, nrm_c, src_valid,
               cfg: StepConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward -> warp -> re-projection -> matching -> losses (the image /
    hard branch of the reference's ``_loss_tail``)."""
    spec = cfg.proj
    H, W = spec.height, spec.width
    T = forward_pose(model, image_1, image_2)
    B = T.shape[0]

    # Keys from the detached warp; the payload is the ORIGINAL xyz, normal
    # and a constant 1, so the warp is re-applied per pixel below.
    pos_sel = se3.transform_points(T.detach(), pts_c)
    vals = torch.cat([pts_c, nrm_c, torch.ones_like(pts_c[..., :1])], dim=-1)
    wimage, placement_overflow = _warped_image(pos_sel, src_valid, vals, spec)

    # Rows [x, n, o] -> [x R^T + o t, n R^T, o]: one affine over the image.
    A = T.new_zeros(B, 7, 7)
    A[:, 0:3, 0:3] = T[:, :3, :3]
    A[:, 3:6, 3:6] = T[:, :3, :3]
    A[:, 0:3, 6] = T[:, :3, 3]
    A[:, 6, 6] = 1.0
    s_all = torch.einsum("bhwc,bdc->bhwd", wimage, A)
    s_xyz = s_all[..., 0:3].reshape(B, H * W, 3)
    s_nrm = s_all[..., 3:6].reshape(B, H * W, 3)
    s_occ = wimage[..., 6].reshape(B, H * W) > 0.5
    corr = image_space_correspondence_batch(s_xyz, s_occ, image_1, target_normal_image,
                                            spec, cfg.window)
    per_pair = icp_losses(s_xyz, s_nrm, corr.valid, corr, cfg.icp)

    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    loss_identity = ((T - eye) ** 2).mean()
    loss_pc = per_pair["loss_pc"].mean()
    loss = loss_identity if cfg.supervised else loss_pc

    # Warped source points inside the vertical FoV (the reference's
    # visible-pixel statistic).
    _, v_pix = compute_uv(pos_sel, spec)
    visible = ((torch.round(v_pix) < H) & (v_pix > 0.0) & src_valid).sum(-1)

    metrics = {
        "loss": loss,
        "loss_pc": loss_pc,
        "loss_po2po": per_pair["loss_po2po"].mean(),
        "loss_po2pl": per_pair["loss_po2pl"].mean(),
        "loss_pl2pl": per_pair["loss_pl2pl"].mean(),
        "loss_po2pl_rev": loss_pc.new_zeros(()),
        "loss_identity": loss_identity,
        "num_po2pl_pairs": per_pair["num_po2pl_pairs"].to(torch.float32).mean(),
        "visible_pixels": visible.to(torch.float32).mean(),
        # Tiles over which the reference's XLA placement would have dropped
        # winners; the port drops none (0 in normal operation).
        "placement_overflow_tiles": placement_overflow,
    }
    return loss, metrics


def loss_and_metrics_fullcached(model, batch: FullyCachedBatch, cfg: StepConfig
                                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and metrics of one :class:`FullyCachedBatch` (augmentation off).

    Under pair normalization the source points and both images (all four
    channels are linear in 1/s) are divided by s, the mean of the two scans'
    mean ranges; the target normal image is not.
    """
    image_1, image_2, src_pts = batch.image_1, batch.image_2, batch.src_points
    if cfg.normalization_scaling:
        s = (0.5 * (batch.mean_range_1 + batch.mean_range_2))[:, None, None]
        src_pts = src_pts / s
        image_1 = image_1 / s[..., None]
        image_2 = image_2 / s[..., None]
    return _loss_tail(model, image_1, batch.normal_image_1, image_2, src_pts,
                      batch.src_normals, batch.src_valid, cfg)


def optax_global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def train_step(model, optimizer: torch.optim.Optimizer, batch: FullyCachedBatch,
               cfg: StepConfig, schedule: Optional[torch.optim.lr_scheduler.LRScheduler] = None
               ) -> Dict[str, torch.Tensor]:
    """One Adam step on ``batch`` -> the step's metrics and ``grad_norm``, as
    0-d tensors on the batch's device (not read back)."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_and_metrics_fullcached(model, batch, cfg)
    loss.backward()
    metrics["grad_norm"] = optax_global_norm(
        [p.grad for p in model.parameters() if p.grad is not None])
    optimizer.step()
    if schedule is not None:
        schedule.step()
    return {k: v.detach() for k, v in metrics.items()}
