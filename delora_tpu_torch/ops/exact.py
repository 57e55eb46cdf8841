"""Single-rounded float32 arithmetic on the CPU, as the card and the
reference's compiled code form it.

The reference's compiled kernels contract products and sums into fmas, each
rounded once to float32; the port's kernels do the same with ``__fmaf_rn``.
The plain PyTorch versions, the projection and the tests reproduce those
single roundings with :func:`fma_exact`.
"""

from __future__ import annotations

import torch


def fma_exact(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors, rounded once, as the card's fmaf.

    a * b is exact in float64. The float64 sum is formed with round-to-odd
    (its exact error by TwoSum decides the last bit), so the final rounding
    to float32 is the single rounding of the exact a * b + c."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (c - (s - bp)) + (p - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def squared_distance(d: torch.Tensor) -> torch.Tensor:
    """|d|^2 over the last axis as the reference's compiled matcher forms it:
    fma(dz, dz, fma(dy, dy, dx * dx)), each fma rounded once to float32."""
    x, y, z = d.unbind(-1)
    return fma_exact(z, z, fma_exact(y, y, x * x))
