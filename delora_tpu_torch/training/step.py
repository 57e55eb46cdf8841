"""The training step of both feeds, and the model forward to SE(3)
transforms that serving shares.

The port of ``delora_tpu/training/step.py``'s ``forward_pose``,
``StepConfig``, ``ScanPairBatch``, ``CachedTargetBatch``,
``FullyCachedBatch``, ``_augment``, ``loss_and_metrics``,
``loss_and_metrics_cached``, ``loss_and_metrics_fullcached``, ``_loss_core``,
``_loss_tail`` and ``optax_global_norm``, with ``train_step`` in place of the
jitted ``make_train_step`` / ``make_train_step_cached`` /
``make_train_step_fullcached`` and ``infer_step`` in place of
``make_infer_step``. One step of the image matcher:

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

Projective correspondence warps the compacted source with gradient and
matches each point against a window of the target image around its pixel
(``ops/correspondence.py::projective_correspondence``, PyTorch ops). Brute
correspondence (raw feed only) warps it the same way and matches it against
the raw target cloud's survivors by exact 1-NN (the 1-NN kernel).

The three feeds: fully cached (both scans' projection artifacts), cached
target (the target's artifacts and the raw source) and raw (both clouds).
Where the source is raw it is projected and compacted in the step
(``_loss_core``) by ``project_compact_exact_batch`` at every image size: its
winners and their pixel-ascending order are the reference's
``project_compact_exact_batch`` below 65,536 pixels and its
``project_scan_compact`` from there on. The raw feed's target is projected
the same way for the image and projective matchers below 65,536 pixels, else
(and for brute) by ``project_scan_batch``.

Augmentation (``augment``) rotates the source scan by a small random
rotation before anything else reads it: points and normals times R^T, R from
an axis in the positive octant (or the z axis) and an angle within
+-magnitude/2 (:func:`augment_rotations`). The fully-cached feed rotates its
compacted survivors and projects them again, so a point that lost its pixel
before the rotation cannot win one after it: the reference's documented
deviation (its step.py:553-580), kept. Every loss function takes the
rotations from its caller; :func:`train_step` draws them from its
``augment_generator`` when it is not given them.

No kernel needs a backward: each sees only detached inputs, as the TPU
kernels see only stop-gradient inputs in the reference. Parameters, losses and
the optimizer stay float32; ``compute_dtype: bfloat16`` is autocast around the
model only.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from delora_tpu_torch import se3
from delora_tpu_torch.config import validate
from delora_tpu_torch.losses.icp import IcpLossConfig, icp_losses
from delora_tpu_torch.ops.correspondence import (
    brute_force_correspondence,
    image_space_correspondence_batch,
    projective_correspondence,
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
                 deterministic: bool = False, shard=None):
    """Model forward on ``[B, H, W, C]`` image pairs -> ``[B, 4, 4]``
    transforms (and the raw translation and quaternion if ``quat_also``);
    ``generator`` draws the dropout masks of a model in training mode, and
    ``deterministic`` turns its dropout off for this call; ``shard`` (a
    ``parallel/dist.py::BatchShard``) says the images are one process's share
    of a global batch."""
    translation, quat = model(image_1, image_2, generator, deterministic, shard)
    T = se3.transform_from_quat(translation, quat)
    if quat_also:
        return T, translation, quat
    return T


class StepConfig(NamedTuple):
    """What the step reads of the config, for one dataset and phase."""

    proj: ProjectionSpec
    icp: IcpLossConfig
    correspondence: str = "image"             # "image" | "projective" | "brute"
    window: Tuple[int, int] = (5, 9)
    supervised: bool = False                  # identity-fit warmup phase
    augment: bool = False                     # random rotation of the source
    augment_only_yaw: bool = False
    augment_magnitude_rad: float = 0.0698     # 4 degrees
    normalization_scaling: bool = False
    # Dropout off in the loss forward (the reference's Tester sets it so that
    # test-time losses are deterministic); the step leaves the model's
    # train/eval mode to its caller.
    deterministic: bool = False
    # > 0 (metres): soft window matching, w = exp(-sq / sigma^2).
    soft_match_sigma: float = 0.0
    # > 0: weight of the reverse point-to-plane term (image matcher only).
    lambda_rev_po2pl: float = 0.0
    # This process's share of the global batch under data parallelism (a
    # parallel/dist.py::BatchShard; the trainer sets it in a process group),
    # else None.
    shard: Optional[Any] = None

    @classmethod
    def from_config(cls, config, dataset: str = "kitti", *, supervised: bool):
        validate(config)
        return cls(
            proj=ProjectionSpec.from_config(config, dataset),
            icp=IcpLossConfig.from_config(config),
            correspondence=str(config["correspondence"]),
            window=tuple(int(w) for w in config["projective_window"]),
            supervised=supervised,
            augment=bool(config["random_point_cloud_rotations"]),
            augment_only_yaw=bool(config["random_rotations_only_yaw"]),
            augment_magnitude_rad=float(config["magnitude_random_rot"]) / 180.0 * math.pi,
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


class CachedTargetBatch(NamedTuple):
    """A batch whose target projection artifacts are precomputed
    (``ops/projection_host.py::scan_artifacts_np``) and whose source is raw.

    image_1:        [B, H, W, 4] target xyz + range (zeros at empty pixels).
    normal_image_1: [B, H, W, 3] target normals (zero = no normal).
    mean_range_1:   [B] target mean range (pair normalization).
    points_2 / normals_2 / valid_2: the source as in :class:`ScanPairBatch`.
    """

    image_1: torch.Tensor
    normal_image_1: torch.Tensor
    mean_range_1: torch.Tensor
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


def augment_rotations(cfg: StepConfig, batch_size: int, generator: torch.Generator
                      ) -> torch.Tensor:
    """The augmentation's ``[B, 3, 3]`` rotations, drawn from ``generator``
    on its device as the reference draws them (step.py:120-133): the axis
    uniform in [0, 1)^3 normalised (so in the positive octant), or z with
    ``augment_only_yaw``; the angle (uniform[0, 1) - 0.5) * magnitude."""
    device = generator.device
    direction = torch.rand((batch_size, 3), generator=generator, device=device)
    if cfg.augment_only_yaw:
        # The z axis, made on the device: a copy from the host cannot be
        # captured in a CUDA graph.
        direction = torch.zeros((batch_size, 3), device=device)
        direction[:, 2] = 1.0
    else:
        direction = direction / torch.clamp(
            torch.linalg.norm(direction, dim=-1, keepdim=True), min=1e-9)
    magnitude = ((torch.rand((batch_size, 1), generator=generator, device=device) - 0.5)
                 * cfg.augment_magnitude_rad)
    return se3.axis_angle_to_rotmat(direction * magnitude)


def _augment(points: torch.Tensor, normals: torch.Tensor,
             rotations: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points and normals ``[B, N, 3]`` rotated by ``rotations`` [B, 3, 3]
    (rows times R^T)."""
    if rotations is None:
        raise ValueError("augmentation is on: pass the [B, 3, 3] rotations "
                         "(train_step draws them from its augment_generator)")
    Rt = rotations.to(points.dtype).transpose(-1, -2)
    return points @ Rt, normals @ Rt


def _mean_range(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B] mean range over the valid points (the reference's mean_range)."""
    m = valid.to(points.dtype)
    return (torch.linalg.norm(points, dim=-1) * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


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
                     deterministic=cfg.deterministic, shard=cfg.shard)
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
    elif cfg.correspondence == "projective":
        src_pts = se3.transform_points(T, pts_c)
        src_nrm = se3.rotate_points(T, nrm_c)
        corr = projective_correspondence(src_pts, src_valid, image_1, target_normal_image,
                                         spec, cfg.window)
        loss_src = (src_pts, src_nrm, src_valid)
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
        raise ValueError(f"unknown correspondence {cfg.correspondence!r}")
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
                                generator: Optional[torch.Generator] = None,
                                rotations: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and metrics of one :class:`FullyCachedBatch` (image or
    projective matcher). ``generator`` draws the dropout masks;
    ``rotations`` [B, 3, 3] rotate the source when ``cfg.augment``.

    Under pair normalization the source points and both images (all four
    channels are linear in 1/s) are divided by s, the mean of the two scans'
    mean ranges; the target normal image is not. With augmentation the
    rotated survivors are projected again (:func:`_loss_core`) in place of
    the cached source image; rotation keeps ranges, so the cached mean range
    still holds.
    """
    if cfg.correspondence not in ("image", "projective"):
        raise ValueError("the fully-cached feed needs the image or the projective matcher")
    image_1, image_2 = batch.image_1, batch.image_2
    src_pts, src_nrm = batch.src_points, batch.src_normals
    if cfg.augment:
        src_pts, src_nrm = _augment(src_pts, src_nrm, rotations)
    if cfg.normalization_scaling:
        s = (0.5 * (batch.mean_range_1 + batch.mean_range_2))[:, None, None]
        src_pts = src_pts / s
        image_1 = image_1 / s[..., None]
        image_2 = image_2 / s[..., None]
    if cfg.augment:
        return _loss_core(model, image_1, batch.normal_image_1, src_pts, src_nrm,
                          batch.src_valid, cfg, generator)
    return _loss_tail(model, image_1, batch.normal_image_1, image_2, src_pts, src_nrm,
                      batch.src_valid, cfg, generator)


def loss_and_metrics_cached(model, batch: CachedTargetBatch, cfg: StepConfig,
                            generator: Optional[torch.Generator] = None,
                            rotations: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and metrics of one :class:`CachedTargetBatch`: the source
    (rotated when ``cfg.augment``) projected and compacted in the step.
    Under pair normalization s is the mean of the cached target mean range
    and the source's, and the source points and all four channels of the
    target image are divided by it."""
    points_2, normals_2 = batch.points_2, batch.normals_2
    if cfg.augment:
        points_2, normals_2 = _augment(points_2, normals_2, rotations)
    image_1 = batch.image_1
    if cfg.normalization_scaling:
        scale = 0.5 * (batch.mean_range_1 + _mean_range(points_2, batch.valid_2))
        points_2 = points_2 / scale[:, None, None]
        image_1 = image_1 / scale[:, None, None, None]
    return _loss_core(model, image_1, batch.normal_image_1, points_2, normals_2,
                      batch.valid_2, cfg, generator)


def _pair_normalization(batch: ScanPairBatch) -> Tuple[ScanPairBatch, torch.Tensor]:
    """Both clouds divided by the mean of their mean ranges over valid points
    (reference step.py:136-147) -> (batch, the [B] scales)."""
    scale = 0.5 * (_mean_range(batch.points_1, batch.valid_1)
                   + _mean_range(batch.points_2, batch.valid_2))
    s = scale[:, None, None]
    return batch._replace(points_1=batch.points_1 / s, points_2=batch.points_2 / s), scale


def _loss_core(model, image_1, target_normal_image, points_2, normals_2, valid_2,
               cfg: StepConfig, generator=None, brute_target=None):
    """The source scan projected and compacted in the step, at any image
    size (see the module docstring), then :func:`_loss_tail` (reference
    step.py:171-224)."""
    spec = cfg.proj
    vals = torch.cat([points_2, normals_2], dim=-1)
    proj_2 = project_compact_exact_batch(points_2, valid_2, spec, values=vals)
    image_2 = torch.cat([proj_2.image[..., 0:3], proj_2.image[..., 6:7]], dim=-1)
    m = proj_2.comp_mask[..., None]
    pts_c = proj_2.comp_vals[..., 0:3] * m
    nrm_c = proj_2.comp_vals[..., 3:6] * m
    return _loss_tail(model, image_1, target_normal_image, image_2, pts_c, nrm_c,
                      proj_2.comp_mask, cfg, generator, brute_target)


def loss_and_metrics(model, batch: ScanPairBatch, cfg: StepConfig,
                     generator: Optional[torch.Generator] = None,
                     rotations: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss and metrics of one raw :class:`ScanPairBatch`: the source
    rotated when ``cfg.augment``, then both scans projected here.
    ``generator`` draws the dropout masks."""
    if cfg.augment:
        points_2, normals_2 = _augment(batch.points_2, batch.normals_2, rotations)
        batch = batch._replace(points_2=points_2, normals_2=normals_2)
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


_LOSS_FNS = {FullyCachedBatch: loss_and_metrics_fullcached,
             CachedTargetBatch: loss_and_metrics_cached,
             ScanPairBatch: loss_and_metrics}


def train_step(model, optimizer: torch.optim.Optimizer,
               batch: Union[FullyCachedBatch, CachedTargetBatch, ScanPairBatch],
               cfg: StepConfig,
               schedule: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
               ema=None, generator: Optional[torch.Generator] = None,
               augment_generator: Optional[torch.Generator] = None,
               rotations: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One Adam step on a batch of any feed -> the step's metrics and
    ``grad_norm``, as 0-d tensors on the batch's device (not read back):
    :func:`update_step`, then ``schedule`` advanced by one update."""
    metrics = update_step(model, optimizer, batch, cfg, ema, generator, augment_generator,
                          rotations)
    if schedule is not None:
        schedule.step()
    return metrics


def update_step(model, optimizer: torch.optim.Optimizer,
                batch: Union[FullyCachedBatch, CachedTargetBatch, ScanPairBatch],
                cfg: StepConfig, ema=None, generator: Optional[torch.Generator] = None,
                augment_generator: Optional[torch.Generator] = None,
                rotations: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The step of :func:`train_step` up to and including Adam's update and
    the EMA, with no Python between its launches that reads the device: the
    part a CUDA graph captures (``training/graphed.py``); the learning-rate
    schedule is its caller's.
    ``ema`` (a ``training/state.py::ParamEma``) folds in the updated
    parameters; ``generator`` draws the dropout masks. With ``cfg.augment``
    the source is rotated by ``rotations`` [B, 3, 3], else by rotations drawn
    from ``augment_generator`` (:func:`augment_rotations`).

    Data-parallel when ``cfg.shard`` is set: ``batch`` (and ``rotations``,
    when given) is this process's share of the global batch, the rotations
    are drawn for the global batch and this process keeps its rows, and the
    gradients and the metrics are averaged over the group before
    ``grad_norm`` and Adam (the counts summed), so every process holds the
    global step's values and applies the same update. Each process's loss is
    the mean of its pairs' per-pair means, so the mean over processes is the
    global mean."""
    shard = cfg.shard
    optimizer.zero_grad(set_to_none=True)
    if cfg.augment and rotations is None:
        if augment_generator is None:
            raise ValueError("augmentation is on: train_step needs rotations or an "
                             "augment_generator")
        if shard is None:
            rotations = augment_rotations(cfg, batch[0].shape[0], augment_generator)
        else:
            rotations = shard.rows(augment_rotations(cfg, batch[0].shape[0] * shard.count,
                                                     augment_generator))
    loss, metrics = _LOSS_FNS[type(batch)](model, batch, cfg, generator, rotations)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if shard is not None:
        shard.mean_(grads)
        metrics = shard.reduce_metrics(metrics)
    metrics["grad_norm"] = optax_global_norm(grads)
    optimizer.step()
    if ema is not None:
        ema.update(model)
    return {k: v.detach() for k, v in metrics.items()}
