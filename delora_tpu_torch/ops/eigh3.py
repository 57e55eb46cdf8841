"""Closed-form symmetric 3x3 eigendecomposition, batched, in plain tensor
operations.

The port of ``delora_tpu/ops/eigh3.py``: the eigenvalues by the
trigonometric method (Smith 1961), and the eigenvector of the smallest
eigenvalue as the largest of the cross products of the rows of
``A - lambda I``. It serves the normal estimation of preprocessing, where the
matrices are the covariances of point neighbourhoods.

The arithmetic is the reference's float32, one elementwise operation at a
time, so the card computes what the CPU computes: each sum is spelled out
(a reduction or a fused cross-product kernel may order or contract it
differently on each device), a division by a constant is a product with the
constant's float32 reciprocal (as XLA compiles it, and as PyTorch's CUDA
division by a scalar does), and arccos and cos are taken in float64 and
rounded to float32 (correctly rounded on both devices, where the float32
library functions differ in the last bit). Near a double root the
trigonometric solve loses accuracy as the square root of the float32 epsilon,
so a last-bit difference there moves the eigenvector visibly.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# The reference adds the Python double 2*pi/3 to a float32 angle: it is
# rounded to float32 once.
_TWO_THIRDS_PI = float(np.float32(2.0 * math.pi / 3.0))
# Division by a constant is multiplication by its float32 reciprocal: XLA
# compiles the reference's divisions so, and PyTorch's CUDA division by a
# Python scalar does too, where its CPU division does not.
_THIRD = float(np.float32(1.0) / np.float32(3.0))
_SIXTH = float(np.float32(1.0) / np.float32(6.0))


def _f32(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` in float64, rounded to float32."""
    return fn(x.double()).float()


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def eigenvalues_sym3x3(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Eigenvalues of symmetric ``[..., 3, 3]`` in ascending order
    ``[..., 3]``: exact for symmetric matrices, without branches."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) * _THIRD
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 * _SIXTH, min=eps))

    # det(B) / 2 where B = (A - qI) / p
    det_b = (b00 * (b11 * b22 - a12 * a12)
             - a01 * (a01 * b22 - a12 * a02)
             + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det_b / (2.0 * p * p * p), -1.0, 1.0)
    phi = _f32(torch.arccos, r) * _THIRD

    big = q + 2.0 * p * _f32(torch.cos, phi)
    small = q + 2.0 * p * _f32(torch.cos, phi + _TWO_THIRDS_PI)
    mid = 3.0 * q - big - small
    return torch.stack([small, mid, big], dim=-1)


def smallest_eigenvector_sym3x3(A: torch.Tensor, eps: float = 1e-20
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (unit eigenvector of the smallest eigenvalue ``[..., 3]``, all
    eigenvalues ascending ``[..., 3]``). The largest-norm cross product of
    two rows of ``A - lambda I`` is the stable choice (the first of equal
    norms, as ``jnp.argmax`` and ``torch.argmax`` both take); where every
    cross product is ~0 (an isotropic neighbourhood) the direction is
    undefined and the zero vector, the "no normal" sentinel, is returned."""
    evals = eigenvalues_sym3x3(A, eps)
    lam = evals[..., 0]
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    crosses = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
    sq = crosses * crosses
    norms = sq[..., 0] + sq[..., 1] + sq[..., 2]                        # [..., 3]
    best = torch.argmax(norms, dim=-1)
    best_norm = norms.amax(dim=-1)
    v = torch.gather(crosses, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    v = v / torch.sqrt(torch.clamp(best_norm, min=eps))[..., None]
    v = torch.where((best_norm > eps)[..., None], v, torch.zeros_like(v))
    return v, evals


def check_planarity(eigenvalues: torch.Tensor, epsilon_plane: float,
                    epsilon_line: float) -> torch.Tensor:
    """Plane test on ascending eigenvalues ``[..., 3]``: smallest / sum below
    ``epsilon_plane`` while (smallest + mid) / sum exceeds ``epsilon_line``
    (not a line)."""
    total = eigenvalues.sum(-1)
    total = torch.where(total == 0, torch.ones_like(total), total)
    return ((eigenvalues[..., 0] / total < epsilon_plane)
            & ((eigenvalues[..., 0] + eigenvalues[..., 1]) / total > epsilon_line))
