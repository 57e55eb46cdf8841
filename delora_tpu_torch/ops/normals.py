"""Neighbourhood-PCA normal estimation on range images.

The port of ``delora_tpu/ops/normals.py``. The reference computes it in XLA,
outside any Pallas kernel; here it is plain PyTorch on the scan's device.
Per pixel, over a ``patch_v`` x ``patch_u`` patch:

- patch offsets clamped at the image borders, not wrapped in azimuth;
- the centre pixel is valid only if all three coordinates are nonzero (AND);
- a neighbour counts if any coordinate is nonzero (OR) and its range is
  within ``epsilon_range`` of the centre's;
- the covariance of the counted neighbours from their first and second
  moments, (sum p p^T - n mean mean^T) / (n - 1);
- at least ``min_neighbors`` neighbours, else no normal;
- the normal turned toward the sensor (n . p > 0 flips it);
- pixels without a normal hold (0, 0, 0).

The moments accumulate over the offsets in the reference's order, and the
second moments and the covariance take the compiler's contraction of the
reference's ``s2 + nbw * nb`` and ``s2 - n mean mean^T`` into single-rounded
fmas (``ops/exact.py::fma_exact``). So the neighbour counts, the moments and
the covariance are bit-equal to the jitted reference on the CPU, and the same
on the card as on the CPU. The closed-form eigensolver that follows
(``ops/eigh3.py``) computes the same float32 on both devices; its arccos and
cos differ from XLA's in the last bit, which moves a normal visibly only where
the neighbourhood's two smallest eigenvalues are close (a line of points),
and there the reference's own rounding decides it too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from delora_tpu_torch.ops.eigh3 import smallest_eigenvector_sym3x3
from delora_tpu_torch.ops.exact import fma_exact


class NormalsSpec(NamedTuple):
    patch_v: int           # neighborhood_side_length[0] (vertical extent, odd)
    patch_u: int           # neighborhood_side_length[1] (horizontal extent, odd)
    epsilon_range: float
    min_neighbors: int

    @classmethod
    def from_config(cls, config, dataset: str):
        side = config[dataset]["neighborhood_side_length"]
        return cls(
            patch_v=int(side[0]),
            patch_u=int(side[1]),
            epsilon_range=float(config["epsilon_range"]),
            min_neighbors=int(config["min_num_points_in_neighborhood_to_determine_point_class"]),
        )


def compute_normal_image(image_xyz: torch.Tensor, spec: NormalsSpec) -> torch.Tensor:
    """Range image ``[H, W, 3]`` (zeros at empty pixels) -> normals
    ``[H, W, 3]``, the zero vector where no normal could be estimated."""
    a, b = spec.patch_v // 2, spec.patch_u // 2
    H, W, _ = image_xyz.shape
    dev = image_xyz.device
    center_valid = (image_xyz != 0.0).all(-1)
    center_range = torch.linalg.norm(image_xyz, dim=-1)
    # Edge padding as an index clamp: offset d reads row clamp(i + d - a).
    rows = (torch.arange(H, device=dev)[None] + torch.arange(spec.patch_v, device=dev)[:, None]
            - a).clamp(0, H - 1)
    cols = (torch.arange(W, device=dev)[None] + torch.arange(spec.patch_u, device=dev)[:, None]
            - b).clamp(0, W - 1)

    count = image_xyz.new_zeros(H, W)
    s1 = image_xyz.new_zeros(H, W, 3)
    s2 = image_xyz.new_zeros(H, W, 3, 3)
    for dv in range(spec.patch_v):
        band = image_xyz[rows[dv]]
        for du in range(spec.patch_u):
            nb = band[:, cols[du]]
            nonzero = (nb != 0.0).any(-1)
            ok = nonzero & ((torch.linalg.norm(nb, dim=-1) - center_range).abs()
                            <= spec.epsilon_range)
            w = ok.to(image_xyz.dtype)
            nbw = nb * w[..., None]
            count = count + w
            s1 = s1 + nbw
            s2 = fma_exact(nbw[..., :, None].expand(-1, -1, 3, 3),
                           nb[..., None, :].expand(-1, -1, 3, 3), s2)

    n_safe = torch.clamp(count, min=2.0)                      # no /0, no /(n-1) = 0
    mean = s1 / n_safe[..., None]
    cov = fma_exact(-(n_safe[..., None, None] * mean[..., :, None]).expand(-1, -1, 3, 3),
                    mean[..., None, :].expand(-1, -1, 3, 3), s2)
    cov = cov / (n_safe - 1.0)[..., None, None]
    normal, _ = smallest_eigenvector_sym3x3(cov)

    prod = normal * image_xyz
    dots = prod[..., 0] + prod[..., 1] + prod[..., 2]
    normal = torch.where((dots > 0.0)[..., None], -normal, normal)
    enough = center_valid & (count >= spec.min_neighbors)
    return torch.where(enough[..., None], normal, torch.zeros_like(normal))


def normals_for_points(image_xyz: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       survivor: torch.Tensor, spec: NormalsSpec) -> torch.Tensor:
    """A normal per point of a projected scan ``-> [N, 3]``: each point reads
    the normal at its own pixel (``u``, ``v``: the projection's unrounded
    coordinates, rounded half to even as ``jnp.round``), and points that did
    not win their pixel get (0, 0, 0), so the array is row-aligned with the
    scan (the reference's on-disk contract)."""
    H, W = image_xyz.shape[0], image_xyz.shape[1]
    flat = compute_normal_image(image_xyz, spec).reshape(-1, 3)
    ui = torch.round(u).to(torch.int64).clamp(0, W - 1)
    vi = torch.round(v).to(torch.int64).clamp(0, H - 1)
    return flat[vi * W + ui] * survivor[:, None].to(flat.dtype)
