"""Norm-free, circular-padded ResNet backbone for range images.

The port of ``delora_tpu/models/resnet.py``, in NCHW: a torchvision-shaped
ResNet-18 without normalisation layers, with the azimuth (W) wrapped before
every conv, anisotropic strides (1,2)/(1,2)/(1,2)/(2,2) and tanh or relu.
Module names follow the original DeLORA model (``conv1``,
``layer{L}.{B}.conv{1,2}``, ``downsample.0``, ``fc``).

Dropout (``use_dropout``, off by default) is the reference's three Flax
``nn.Dropout(0.2)`` sites: elementwise on the stem's input, one mask per
(batch, channel) after stage 3 (``broadcast_dims=(1, 2)``), elementwise on the
fc output. It runs only in training mode (``model.train()``) and where the
forward's ``deterministic`` (the reference's flag) is false; ``model.eval()``
turns it off as ``deterministic=True`` does. It draws its bits from the
``torch.Generator`` the caller passes, never from the global RNG.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def activation_fn(name: str):
    return torch.relu if name == "relu" else torch.tanh


def kaiming_normal_out_(weight: torch.Tensor, activation: str,
                        generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal fan-out init, as the reference's
    ``variance_scaling(gain**2, "fan_out", "truncated_normal")``: gain sqrt(2)
    for relu, 5/3 for tanh; fan_out = out_channels * kh * kw."""
    gain_sq = 2.0 if activation == "relu" else (5.0 / 3.0) ** 2
    fan_out = weight.shape[0] * weight[0, 0].numel()
    # Std of the unit normal truncated to [-2, 2].
    std = math.sqrt(gain_sq / fan_out) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def linear_init_(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch.nn.Linear's default: weight and bias U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
        nn.init.uniform_(layer.bias, -bound, bound, generator=generator)


DROPOUT_RATE = 0.2


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            channels: bool = False) -> torch.Tensor:
    """Flax's ``nn.Dropout``: keep each element (or, with ``channels``, each
    [batch, channel] plane of an NCHW tensor) with probability 1 - rate and
    divide the survivors by 1 - rate; the rest are 0."""
    keep = 1.0 - rate
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channels else x.shape
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def pad_circular_w(x: torch.Tensor, pad_w: int = 1, pad_h: int = 1,
                   height_value: float = 0.0) -> torch.Tensor:
    """Wrap-pad azimuth (W), constant-pad rings (H). x: [B, C, H, W]."""
    if pad_w:
        x = torch.cat([x[..., -pad_w:], x, x[..., :pad_w]], dim=-1)
    if pad_h:
        x = F.pad(x, (0, 0, pad_h, pad_h), value=height_value)
    return x


class ConvCirc(nn.Conv2d):
    """Bias-free conv after a circular width pad; the height is zero-padded
    by the conv itself (k//2 rows), the width by the wrap only."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1)):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=(kernel[0] // 2, 0), bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(pad_circular_w(x, pad_w=self.kernel_size[1] // 2, pad_h=0))


class BasicBlock(nn.Module):
    """Two 3x3 circular convs + identity or 1x1 projection skip, no norm."""

    def __init__(self, in_channels: int, features: int,
                 stride: Tuple[int, int], activation: str):
        super().__init__()
        self.act = activation_fn(activation)
        self.conv1 = ConvCirc(in_channels, features, stride=stride)
        self.conv2 = ConvCirc(features, features)
        self.downsample = None
        if tuple(stride) != (1, 1) or in_channels != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, features, 1, stride=stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.act(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return self.act(out + identity)


class CircularResNet(nn.Module):
    """Stem, four stages, global mean and ``fc``; returns the fc output,
    with dropout at the three sites of the module docstring when
    ``use_dropout`` and in training mode."""

    STAGE_STRIDES = ((1, 1), (1, 2), (1, 2), (2, 2))

    def __init__(self, in_channels: int, num_outputs: int = 1000,
                 blocks_per_stage: Sequence[int] = (2, 2, 2, 2),
                 channel_divisor: int = 1,
                 stage_width_multipliers: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 activation: str = "tanh", use_dropout: bool = False):
        super().__init__()
        self.act = activation_fn(activation)
        self.use_dropout = use_dropout
        widths = [int(c * m / channel_divisor)
                  for c, m in zip((64, 128, 256, 512), stage_width_multipliers)]
        self.conv1 = ConvCirc(in_channels, widths[0], stride=(1, 2))
        cin = widths[0]
        for stage, (width, stride, blocks) in enumerate(
                zip(widths, self.STAGE_STRIDES, blocks_per_stage)):
            layer = []
            for block in range(blocks):
                layer.append(BasicBlock(cin, width, stride if block == 0 else (1, 1),
                                        activation))
                cin = width
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(widths[3], num_outputs)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = False) -> torch.Tensor:
        """x: [B, C, H, W] -> [B, num_outputs]; ``generator`` draws the
        dropout masks (needed when dropout is active: ``use_dropout``, training
        mode and not ``deterministic``)."""
        drop = self.use_dropout and self.training and not deterministic
        if drop and generator is None:
            raise ValueError("dropout in training mode needs a torch.Generator")
        if drop:
            x = dropout(x, DROPOUT_RATE, generator)
        x = self.act(self.conv1(x))
        # 3x3 max-pool, stride (1, 2): rows padded with -inf, azimuth wrapped.
        x = F.max_pool2d(pad_circular_w(x, 1, 1, -math.inf), 3, stride=(1, 2))
        x = self.layer3(self.layer2(self.layer1(x)))
        if drop:
            x = dropout(x, DROPOUT_RATE, generator, channels=True)
        out = self.fc(self.layer4(x).mean(dim=(2, 3)))
        return dropout(out, DROPOUT_RATE, generator) if drop else out

