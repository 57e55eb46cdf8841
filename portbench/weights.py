"""The network's weights, made on the device from the run's seed.

DeLORA's initialisation: every convolution a normal truncated to two
standard deviations, of variance gain^2 / fan-out (gain 5/3 for tanh,
sqrt(2) for relu); every linear layer's weight and bias uniform in
+-1/sqrt(fan-in). Two draws in all, one for the convolutions and one for
the linears, in float32, the type the model keeps its parameters in.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from portbench.reference.model import ParamSpec

# The standard deviation of the unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (1 << 63)


def make(specs: Sequence[ParamSpec], seed: int, device, activation: str = "tanh"
         ) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    gain_sq = 2.0 if activation == "relu" else (5.0 / 3.0) ** 2
    out: Dict[str, torch.Tensor] = {}
    for kind in ("conv", "linear"):
        group = [s for s in specs if s.init == kind]
        total = sum(math.prod(s.shape) for s in group)
        u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
        if kind == "conv":
            # Inverse CDF of the unit normal restricted to [-2, 2].
            lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
            z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
            z = z.clamp(-2.0, 2.0)
        else:
            z = 2 * u - 1
        offset = 0
        for s in group:
            n = math.prod(s.shape)
            scale = (math.sqrt(gain_sq / s.fan) / _TRUNC_STD if kind == "conv"
                     else 1.0 / math.sqrt(s.fan))
            out[s.name] = (z[offset:offset + n] * scale).reshape(s.shape)
            offset += n
    return {s.name: out[s.name] for s in specs}
