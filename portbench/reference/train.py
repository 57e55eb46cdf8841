"""Plain PyTorch reference of DeLORA's self-supervised training step (the
image matcher on both scans' cached projections), and the first steps of Adam.

Per pair (target scan t, source scan t+1):

1. both scans' range images, the target's normal image, and the source's
   surviving points and normals in pixel order (``geometry.range_image``);
2. the network's transform T of the two images (the quaternion normalised
   per row);
3. the surviving source points moved by T (no gradient) and projected again
   under the packed rule, each pixel keeping its winner's original point,
   normal and a 1;
4. each pixel's point and normal moved by T again, now with gradient;
5. the hard window match of the moved points against the target image;
6. the point-to-plane loss ((s - t) . n_t)^2 and the plane-to-plane loss
   |n_s - n_t|^2, each the mean over the matched pixels where both points
   have a normal, summed, and averaged over the batch;
7. Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from portbench.reference import geometry, model

BETAS = (0.9, 0.999)
EPS = 1e-8


# The training keys this reference computes; any other value is refused.
IMPLEMENTED = {"correspondence": "image", "soft_match_sigma": 0.0, "lambda_po2pl": 1.0,
               "lambda_pl2pl": 1.0, "point_to_plane_loss": True, "plane_to_plane_loss": True,
               "point_to_point_loss": False, "normal_loss": "squared",
               "lambda_reverse_po2pl": 0.0, "normalization_scaling": False,
               "random_point_cloud_rotations": False, "use_dropout": False, "ema_decay": 0.0,
               "cache_target_projections": True, "cache_source_projections": True,
               "unsupervised_at_start": True, "po2pl_trim_distance": 0.0}


def check_config(training: Dict) -> None:
    for key, want in IMPLEMENTED.items():
        if training.get(key, want) != want:
            raise ValueError(f"the reference computes {key}={want!r}, the cell asks "
                             f"{training[key]!r}")


class Scan(NamedTuple):
    image: torch.Tensor         # [H, W, 4]
    normal_image: torch.Tensor  # [H, W, 3]
    points: torch.Tensor        # [S, 3] survivors in pixel order
    normals: torch.Tensor       # [S, 3]


def prepare(points: torch.Tensor, normals: torch.Tensor, spec: geometry.Spec,
            max_points: int) -> Scan:
    """A raw scan (its first ``max_points`` points) -> what the step reads."""
    points, normals = points[:max_points, 0:3].float(), normals[:max_points, 0:3].float()
    image, ids, wpix = geometry.range_image(points, spec)
    nimg = torch.zeros(spec.height * spec.width, 3, device=points.device)
    nimg[wpix] = normals[ids]
    return Scan(image, nimg.reshape(spec.height, spec.width, 3), points[ids], normals[ids])


def _batch_images(scans: Sequence[Scan]) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.stack([s.image for s in scans]),
            torch.stack([s.normal_image for s in scans]))


def _warped(T: torch.Tensor, src: Scan, spec: geometry.Spec) -> torch.Tensor:
    """[H, W, 7]: each pixel's winner (packed rule) among the source
    survivors moved by T, as its original point, normal and a 1."""
    R, t = T[:3, :3], T[:3, 3]
    moved = src.points @ R.T + t
    valid = torch.ones(moved.shape[0], dtype=torch.bool, device=moved.device)
    r, pix = geometry.pixels(moved, valid, spec)
    hw = spec.height * spec.width
    ids, wpix = geometry.winners_packed(r, pix, hw)
    out = torch.zeros(hw, 7, device=moved.device)
    out[wpix, 0:3] = src.points[ids]
    out[wpix, 3:6] = src.normals[ids]
    out[wpix, 6] = 1.0
    return out.reshape(spec.height, spec.width, 7)


def loss_at(T: torch.Tensor, pairs: Sequence[Tuple[Scan, Scan]], spec: geometry.Spec,
            window: Tuple[int, int]) -> torch.Tensor:
    """The batch's mean of po2pl + pl2pl over its pairs, the source moved by
    the transforms ``T`` ``[B, 4, 4]`` (steps 3 to 6)."""
    tgt_img, tgt_nrm = _batch_images([p[0] for p in pairs])
    wimg = torch.stack([_warped(T[i].detach(), p[1], spec) for i, p in enumerate(pairs)])
    R, t = T[:, :3, :3], T[:, :3, 3]
    occ = wimg[..., 6:7]
    s_xyz = torch.einsum("bhwc,bdc->bhwd", wimg[..., 0:3], R) + occ * t[:, None, None, :]
    s_nrm = torch.einsum("bhwc,bdc->bhwd", wimg[..., 3:6], R)
    found, m_xyz, m_nrm = geometry.window_match(s_xyz.detach(), tgt_img[..., 0:3], tgt_nrm,
                                                window)
    both = (found & (occ[..., 0] > 0.5) & geometry.occupied(s_nrm.detach())
            & geometry.occupied(m_nrm))
    w = both.float()
    count = w.sum(dim=(1, 2)).clamp(min=1.0)
    po2pl = (((s_xyz - m_xyz) * m_nrm).sum(-1) ** 2 * w).sum(dim=(1, 2)) / count
    pl2pl = (((s_nrm - m_nrm) ** 2).sum(-1) * w).sum(dim=(1, 2)) / count
    return (po2pl + pl2pl).mean()


class Follow(NamedTuple):
    losses: List[float]
    poses: List[torch.Tensor]           # per step, [B, 4, 4] of the network's forward
    rounded: torch.Tensor               # the first step's [B, 4, 4] in bfloat16
    first_grad: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]


def follow(weights: Dict[str, torch.Tensor], batches: Sequence[Sequence[Tuple[Scan, Scan]]],
           spec: geometry.Spec, arch: model.Arch, window: Tuple[int, int], lr: float,
           quant: model.Quant = None, given: Optional[Sequence[torch.Tensor]] = None,
           autocast: Optional[torch.dtype] = None, channels_last: bool = False) -> Follow:
    """Adam steps from ``weights``, one a batch -> each step's loss and
    transforms, the first step's gradient, and the change of every weight
    after the last step.

    With ``given`` (a step's ``[b, 4, 4]`` transforms, b <= B, of the run
    being followed), steps 3 to 6 start from those transforms rather than
    the network's own (rows past b take the network's): the hard matcher is
    discontinuous in the transform, so two forwards that differ in rounding
    would match differently. The gradient still flows back through this
    network: its transform's gradient is that of the loss at the given
    transform. ``autocast`` and ``channels_last`` run the network as
    ``model.pose`` does (calibration)."""
    names = list(weights)
    params = [weights[k].detach().clone().requires_grad_(True) for k in names]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, poses, first, rounded = [], [], None, None
    for step, pairs in enumerate(batches, start=1):
        w = dict(zip(names, params))
        tgt_img, _ = _batch_images([p[0] for p in pairs])
        src_img, _ = _batch_images([p[1] for p in pairs])
        T_net = model.pose(w, tgt_img, src_img, arch, quant, autocast, channels_last)
        if rounded is None:
            with torch.no_grad():
                rounded = model.pose(w, tgt_img, src_img, arch, autocast=torch.bfloat16)
        T_use = T_net.detach().clone()
        if given is not None:
            b = given[step - 1].shape[0]
            T_use[:b] = given[step - 1].to(T_use)
        T_use.requires_grad_(True)
        value = loss_at(T_use, pairs, spec, window)
        (dT,) = torch.autograd.grad(value, T_use)
        grads = torch.autograd.grad(T_net, params, grad_outputs=dT)
        losses.append(float(value.detach()))
        poses.append(T_net.detach())
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            c1, c2 = 1 - BETAS[0] ** step, 1 - BETAS[1] ** step
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                vi.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                p.sub_(lr / c1 * mi / ((vi / c2).sqrt() + EPS))
    change = {k: (p.detach() - weights[k]) for k, p in zip(names, params)}
    return Follow(losses, poses, rounded, first, change)
