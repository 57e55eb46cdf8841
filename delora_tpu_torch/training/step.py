"""The training step of both feeds, and the model forward to SE(3)
transforms that serving shares.

The port of ``delora_tpu/training/step.py``'s ``forward_pose``,
``StepConfig``, ``ScanPairBatch``, ``FullyCachedBatch``, ``loss_and_metrics``,
``_loss_core``, ``_loss_tail``, ``loss_and_metrics_fullcached`` (augmentation
off) and ``optax_global_norm``, with ``train_step`` in place of the jitted
``make_train_step`` / ``make_train_step_fullcached`` and ``infer_step`` in
place of ``make_infer_step``. One step of the image
matcher:

  1. model forward on the range images -> T [B, 4, 4] (dropout in training
     mode unless ``deterministic``);
  2. the compacted source points warped by the DETACHED T and re-projected
     under the packed winner rule (``project_image_packed_batch``: the
     placement kernel), storing each winner's original xyz, normal and a
     constant 1 (occupancy, and the homogeneous coordinate of step 3);
  3. one per-pixel 7x7 affine ``s_all = wimage @ A(T)^T`` re-applies the warp
     with gradient: the only gradient path to T, elementwise;
  4. hard or soft window matching of s_all's xyz against the target image
     (the window matcher kernels), on a detached copy; with
     ``lambda_rev_po2pl`` > 0 also the reverse direction (target pixels
     against s_all, the index kernel), its winners re-gathered from s_all
     with gradient;
  5. the ICP losses, the supervised identity loss, the metrics.

Brute correspondence (raw feed only) warps the compacted source with
gradient and matches it against the raw target cloud's survivors by exact
1-NN (the 1-NN kernel). On the raw feed both scans are projected in the step
first (``_loss_core``, ``loss_and_metrics``): the source and, for the image
matcher, the target by ``project_compact_exact_batch``; the brute target by
``project_scan_batch``.

No kernel needs a backward: each sees only detached inputs, as the TPU
kernels see only stop-gradient inputs in the reference. Parameters, losses and
the optimizer stay float32; ``compute_dtype: bfloat16`` is autocast around the
model only.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from delora_tpu_torch import se3
from delora_tpu_torch.config import validate
from delora_tpu_torch.losses.icp import IcpLossConfig, icp_losses
from delora_tpu_torch.ops.correspondence import (
    brute_force_correspondence,
    image_space_correspondence_batch,
    window_match_indices,
)
from delora_tpu_torch.ops.cuda.placement import placement
from delora_tpu_torch.ops.cuda.window_match import winner_pixel
from delora_tpu_torch.ops.projection import (
    ProjectionSpec,
    _pixel_coords,
    compute_uv,
    gather_image_attribute,
    project_compact_exact_batch,
    project_image_batch,
    project_image_packed_batch,
    project_scan_batch,
)


def forward_pose(model, image_1: torch.Tensor, image_2: torch.Tensor,
                 quat_also: bool = False, generator: Optional[torch.Generator] = None,
                 deterministic: bool = False):
    """Model forward on ``[B, H, W, C]`` image pairs -> ``[B, 4, 4]``
    transforms (and the raw translation and quaternion if ``quat_also``);
    ``generator`` draws the dropout masks of a model in training mode, and
    ``deterministic`` turns its dropout off for this call."""
    translation, quat = model(image_1, image_2, generator, deterministic)
    T = se3.transform_from_quat(translation, quat)
    if quat_also:
        return T, translation, quat
    return T


class StepConfig(NamedTuple):
    """What the step reads of the config, for one dataset and phase."""

    proj: ProjectionSpec
    icp: IcpLossConfig
    correspondence: str = "image"             # "image" | "brute"
    window: Tuple[int, int] = (5, 9)
    supervised: bool = False                  # identity-fit warmup phase
    normalization_scaling: bool = False
    # Dropout off in the loss forward (the reference's Tester sets it so that
    # test-time losses are deterministic); the step leaves the model's
    # train/eval mode to its caller.
    deterministic: bool = False
    # > 0 (metres): soft window matching, w = exp(-sq / sigma^2).
    soft_match_sigma: float = 0.0
    # > 0: weight of the reverse point-to-plane term (image matcher only).
    lambda_rev_po2pl: float = 0.0

    @classmethod
    def from_config(cls, config, dataset: str = "kitti", *, supervised: bool):
        validate(config)
        return cls(
            proj=ProjectionSpec.from_config(config, dataset),
            icp=IcpLossConfig.from_config(config),
            correspondence=str(config["correspondence"]),
            window=tuple(int(w) for w in config["projective_window"]),
            supervised=supervised,
            normalization_scaling=bool(config["normalization_scaling"]),
            soft_match_sigma=float(config["soft_match_sigma"]),
            lambda_rev_po2pl=float(config["lambda_reverse_po2pl"]),
        )


class ScanPairBatch(NamedTuple):
    """One batch of consecutive scan pairs, fixed shapes: points_* [B, N, 3]
    float32 (padded), normals_* [B, N, 3] (zeros = no normal), valid_* [B, N]
    bool. Scan 1 is the target frame at time t, scan 2 the source at t+1."""

    points_1: torch.Tensor
    normals_1: torch.Tensor
    valid_1: torch.Tensor
    points_2: torch.Tensor
    normals_2: torch.Tensor
    valid_2: torch.Tensor


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


def _reverse_po2pl(s_all, wimage, image_1, cfg: StepConfig) -> torch.Tensor:
    """The reverse point-to-plane term (reference step.py:321-359): every
    occupied target pixel is matched against the warped-source image (index
    kernel, detached), the winner's warped point and normal are gathered from
    ``s_all`` with gradient, and ((t - s) . n_s)^2 is averaged per sample over
    the pairs whose winner has a normal (and, when trimming, lies within the
    trim distance), then over the batch."""
    spec = cfg.proj
    H, W = spec.height, spec.width
    B = s_all.shape[0]
    t_xyz = image_1[..., 0:3].reshape(B, H * W, 3)
    t_occ = image_1[..., 3].reshape(B, H * W) > 0.0
    best_k, sq_r, val_r = window_match_indices(t_xyz, t_occ, s_all[..., 0:3], wimage[..., 6],
                                               spec, cfg.window)
    win = winner_pixel(best_k, cfg.window, H, W)
    matched = torch.gather(s_all.reshape(B, H * W, 7), 1, win[..., None].expand(-1, -1, 7))
    s_m_xyz, s_m_nrm = matched[..., 0:3], matched[..., 3:6]
    ok = val_r & t_occ & (s_m_nrm != 0.0).any(-1)
    if cfg.icp.trim_sq_distance > 0.0:
        ok = ok & (sq_r <= cfg.icp.trim_sq_distance)
    resid = ((t_xyz - s_m_xyz) * s_m_nrm).sum(-1)
    okf = ok.to(resid.dtype)
    per_sample = (resid * resid * okf).sum(1) / torch.clamp(okf.sum(1), min=1.0)
    return per_sample.mean()


def _loss_tail(model, image_1, target_normal_image, image_2, pts_c, nrm_c, src_valid,
               cfg: StepConfig, generator: Optional[torch.Generator] = None,
               brute_target=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward -> warp -> correspondence -> losses, given both images and the
    compacted source point set. ``brute_target`` = (points_1, survivor_1,
    normals_1) is needed by brute correspondence only."""
    spec = cfg.proj
    H, W = spec.height, spec.width
    T = forward_pose(model, image_1, image_2, generator=generator,
                     deterministic=cfg.deterministic)
    B = T.shape[0]
    rev_po2pl = None
    placement_overflow = T.new_zeros(())
    pos_sel = se3.transform_points(T.detach(), pts_c)

    if cfg.correspondence == "image":
        # Keys from the detached warp; the payload is the ORIGINAL xyz, normal
        # and a constant 1, so the warp is re-applied per pixel below.
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
                                                spec, cfg.window, cfg.soft_match_sigma)
        loss_src = (s_xyz, s_nrm, corr.valid)
        if cfg.lambda_rev_po2pl > 0.0:
            rev_po2pl = _reverse_po2pl(s_all, wimage, image_1, cfg)
    elif cfg.correspondence == "brute":
        if brute_target is None:
            raise ValueError("brute-force correspondence needs the raw target points "
                             "(the raw feed)")
        points_1, survivor_1, normals_1 = brute_target
        src_pts = se3.transform_points(T, pts_c)
        src_nrm = se3.rotate_points(T, nrm_c)
        corr = brute_force_correspondence(src_pts, src_valid, points_1, survivor_1, normals_1)
        loss_src = (src_pts, src_nrm, src_valid)
    else:
        raise NotImplementedError(f"correspondence {cfg.correspondence!r} is not ported")
    per_pair = icp_losses(*loss_src, corr, cfg.icp)

    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    loss_identity = ((T - eye) ** 2).mean()
    loss_pc = per_pair["loss_pc"].mean()
    if rev_po2pl is None:
        rev_po2pl = loss_pc.new_zeros(())
    else:
        loss_pc = loss_pc + cfg.lambda_rev_po2pl * rev_po2pl
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
        "loss_po2pl_rev": rev_po2pl,
        "loss_identity": loss_identity,
        "num_po2pl_pairs": per_pair["num_po2pl_pairs"].to(torch.float32).mean(),
        "visible_pixels": visible.to(torch.float32).mean(),
        # Tiles over which the reference's XLA placement would have dropped
        # winners; the port drops none (0 in normal operation).
        "placement_overflow_tiles": placement_overflow,
    }
    return loss, metrics


def loss_and_metrics_fullcached(model, batch: FullyCachedBatch, cfg: StepConfig,
                                generator: Optional[torch.Generator] = None
                                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and metrics of one :class:`FullyCachedBatch` (augmentation off,
    image matcher). ``generator`` draws the dropout masks.

    Under pair normalization the source points and both images (all four
    channels are linear in 1/s) are divided by s, the mean of the two scans'
    mean ranges; the target normal image is not.
    """
    if cfg.correspondence != "image":
        raise ValueError("the fully-cached feed needs the image matcher")
    image_1, image_2, src_pts = batch.image_1, batch.image_2, batch.src_points
    if cfg.normalization_scaling:
        s = (0.5 * (batch.mean_range_1 + batch.mean_range_2))[:, None, None]
        src_pts = src_pts / s
        image_1 = image_1 / s[..., None]
        image_2 = image_2 / s[..., None]
    return _loss_tail(model, image_1, batch.normal_image_1, image_2, src_pts,
                      batch.src_normals, batch.src_valid, cfg, generator)


def _pair_normalization(batch: ScanPairBatch) -> Tuple[ScanPairBatch, torch.Tensor]:
    """Both clouds divided by the mean of their mean ranges over valid points
    (reference step.py:136-147) -> (batch, the [B] scales)."""
    def mean_range(p, m):
        m = m.to(p.dtype)
        return (torch.linalg.norm(p, dim=-1) * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)

    scale = 0.5 * (mean_range(batch.points_1, batch.valid_1)
                   + mean_range(batch.points_2, batch.valid_2))
    s = scale[:, None, None]
    return batch._replace(points_1=batch.points_1 / s, points_2=batch.points_2 / s), scale


def _loss_core(model, image_1, target_normal_image, points_2, normals_2, valid_2,
               cfg: StepConfig, generator=None, brute_target=None):
    """The source scan projected and compacted in the step, then
    :func:`_loss_tail` (reference step.py:171-224)."""
    spec = cfg.proj
    if spec.height * spec.width >= (1 << 16):
        raise NotImplementedError(
            "the raw feed at H*W >= 65536 needs project_scan_compact, which is not ported")
    vals = torch.cat([points_2, normals_2], dim=-1)
    proj_2 = project_compact_exact_batch(points_2, valid_2, spec, values=vals)
    image_2 = torch.cat([proj_2.image[..., 0:3], proj_2.image[..., 6:7]], dim=-1)
    m = proj_2.comp_mask[..., None]
    pts_c = proj_2.comp_vals[..., 0:3] * m
    nrm_c = proj_2.comp_vals[..., 3:6] * m
    return _loss_tail(model, image_1, target_normal_image, image_2, pts_c, nrm_c,
                      proj_2.comp_mask, cfg, generator, brute_target)


def loss_and_metrics(model, batch: ScanPairBatch, cfg: StepConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and metrics of one raw :class:`ScanPairBatch` (augmentation off):
    both scans are projected here. ``generator`` draws the dropout masks."""
    if cfg.normalization_scaling:
        batch, _ = _pair_normalization(batch)
    spec = cfg.proj
    if cfg.correspondence != "brute" and spec.height * spec.width < (1 << 16):
        # Target image and normal image from one placement, normals riding.
        vals = torch.cat([batch.points_1, batch.normals_1], dim=-1)
        timg = project_compact_exact_batch(batch.points_1, batch.valid_1, spec,
                                           values=vals).image
        image_1 = torch.cat([timg[..., 0:3], timg[..., 6:7]], dim=-1)
        target_normal_image = timg[..., 3:6]
        brute_target = None
    else:
        proj_1 = project_scan_batch(batch.points_1, batch.valid_1, spec)
        image_1 = proj_1.image
        target_normal_image = gather_image_attribute(batch.normals_1, proj_1.point_index)
        brute_target = (batch.points_1, proj_1.survivor, batch.normals_1)
    return _loss_core(model, image_1, target_normal_image, batch.points_2, batch.normals_2,
                      batch.valid_2, cfg, generator, brute_target)


@torch.no_grad()
def infer_step(model, batch: ScanPairBatch, cfg: StepConfig) -> torch.Tensor:
    """Inference on a raw batch -> ``[B, 4, 4]`` relative transforms
    (reference ``make_infer_step``, step.py:683-701): both scans projected to
    range images, the model forward without dropout, and under pair
    normalization the translation multiplied back by the pair's scale."""
    scale = None
    if cfg.normalization_scaling:
        batch, scale = _pair_normalization(batch)
    image_1 = project_image_batch(batch.points_1, batch.valid_1, cfg.proj)
    image_2 = project_image_batch(batch.points_2, batch.valid_2, cfg.proj)
    T = forward_pose(model, image_1, image_2, deterministic=True)
    if scale is not None:
        T[:, :3, 3] *= scale[:, None]
    return T


def optax_global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as ``optax.global_norm``."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def train_step(model, optimizer: torch.optim.Optimizer,
               batch: Union[FullyCachedBatch, ScanPairBatch], cfg: StepConfig,
               schedule: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
               ema=None, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One Adam step on a fully-cached or a raw batch -> the step's metrics
    and ``grad_norm``, as 0-d tensors on the batch's device (not read back).
    ``ema`` (a ``training/state.py::ParamEma``) folds in the updated
    parameters; ``generator`` draws the dropout masks."""
    optimizer.zero_grad(set_to_none=True)
    loss_fn = (loss_and_metrics_fullcached if isinstance(batch, FullyCachedBatch)
               else loss_and_metrics)
    loss, metrics = loss_fn(model, batch, cfg, generator)
    loss.backward()
    metrics["grad_norm"] = optax_global_norm(
        [p.grad for p in model.parameters() if p.grad is not None])
    optimizer.step()
    if schedule is not None:
        schedule.step()
    if ema is not None:
        ema.update(model)
    return {k: v.detach() for k, v in metrics.items()}
