"""Odometry model: scan-pair images -> relative pose (translation, quaternion).

The port of ``delora_tpu/models/odometry.py``. The two ``[B, H, W, 4]`` range
images are concatenated channel-wise (optionally after a shared per-image conv
feature extractor), run through the circular ResNet, and regressed by two
activation-first MLP heads (1000 -> 100 -> 4 rotation, -> 3 translation) or
one shared 512-512-256-64-7 MLP (rotation first). Quaternions are (x, y, z, w),
normalized per row or over the whole tensor.

``compute_dtype`` bfloat16 runs the network under ``torch.autocast``;
parameters stay float32 and the outputs come out float32. ``use_dropout``
turns on the backbone's dropout in training mode (``models/resnet.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from delora_tpu_torch.models.resnet import (
    CircularResNet,
    ConvCirc,
    activation_fn,
    kaiming_normal_out_,
    linear_init_,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ModelConfig(NamedTuple):
    resnet_outputs: int = 1000
    blocks_per_stage: Tuple[int, ...] = (2, 2, 2, 2)
    channel_divisor: int = 1
    activation: str = "tanh"
    pre_feature_extraction: bool = False
    use_single_mlp: bool = False
    quaternion_normalization: str = "per_row"   # "per_row" | "global"
    compute_dtype: torch.dtype = torch.float32
    in_channels_per_image: int = 4
    stage_width_multipliers: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    use_dropout: bool = False

    @classmethod
    def from_config(cls, config):
        return cls(
            resnet_outputs=int(config["resnet_outputs"]),
            blocks_per_stage=tuple(config["layers"]),
            channel_divisor=int(config["factor_fewer_resnet_channels"]),
            activation=str(config["activation_fct"]),
            pre_feature_extraction=bool(config["pre_feature_extraction"]),
            use_single_mlp=bool(config["use_single_mlp_at_output"]),
            quaternion_normalization=str(config["quaternion_normalization"]),
            compute_dtype=_DTYPES[config.get("compute_dtype", "float32")],
            stage_width_multipliers=tuple(
                float(m) for m in config.get(
                    "resnet_stage_width_multipliers", (1.0, 1.0, 1.0, 1.0))),
            use_dropout=bool(config.get("use_dropout", False)),
        )


def _mlp(in_features: int, sizes, activation: str) -> nn.Sequential:
    """Activation-first MLP: (act, Linear) per layer, Linears at odd indices."""
    layers = []
    for width in sizes:
        layers += [nn.ReLU() if activation == "relu" else nn.Tanh(),
                   nn.Linear(in_features, width)]
        in_features = width
    return nn.Sequential(*layers)


class OdometryModel(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        """``generator`` seeds the initialisation (a fresh ``torch.Generator``
        seeded 0 if None)."""
        super().__init__()
        self.cfg = cfg
        in_channels = 2 * cfg.in_channels_per_image
        self.feature_extractor = None
        if cfg.pre_feature_extraction:
            # Layer k maps (k * base, or the image's channels at k = 0) to
            # (k + 1) * base channels, base = 2 * in_channels_per_image.
            base = 2 * cfg.in_channels_per_image
            chans = [cfg.in_channels_per_image] + [(k + 1) * base for k in range(5)]
            self.feature_extractor = nn.ModuleList(
                ConvCirc(a, b) for a, b in zip(chans[:-1], chans[1:]))
            in_channels = 2 * chans[-1]
        self.resnet = CircularResNet(
            in_channels, cfg.resnet_outputs, cfg.blocks_per_stage,
            cfg.channel_divisor, cfg.stage_width_multipliers, cfg.activation,
            cfg.use_dropout)
        if cfg.use_single_mlp:
            self.fully_connected_rot_trans = _mlp(
                cfg.resnet_outputs, (512, 512, 256, 64, 7), cfg.activation)
        else:
            self.fully_connected_rotation = _mlp(cfg.resnet_outputs, (100, 4), cfg.activation)
            self.fully_connected_translation = _mlp(cfg.resnet_outputs, (100, 3), cfg.activation)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                kaiming_normal_out_(module.weight, self.cfg.activation, generator)
            elif isinstance(module, nn.Linear):
                linear_init_(module, generator)

    def _extract(self, image: torch.Tensor) -> torch.Tensor:
        act = activation_fn(self.cfg.activation)
        for conv in self.feature_extractor:
            image = act(conv(image))
        return image

    def forward(self, image_1: torch.Tensor, image_2: torch.Tensor,
                generator: Optional[torch.Generator] = None, deterministic: bool = False):
        """image_*: [B, H, W, C] -> (translation [B, 3], quat_xyzw [B, 4]), f32.
        ``generator`` draws the dropout masks in training mode;
        ``deterministic`` (the reference's flag) turns dropout off."""
        cfg = self.cfg
        # Contiguous NCHW: the CPU convolution's backward crashes on the
        # channels-last strides a bare permute leaves.
        x1 = image_1.permute(0, 3, 1, 2).contiguous()
        x2 = image_2.permute(0, 3, 1, 2).contiguous()
        with torch.autocast(x1.device.type, dtype=cfg.compute_dtype,
                            enabled=cfg.compute_dtype != torch.float32):
            if self.feature_extractor is not None:
                x = torch.cat([self._extract(x1), self._extract(x2)], dim=1)
            else:
                x = torch.cat([x1, x2], dim=1)
            feat = self.resnet(x, generator, deterministic)
            if cfg.use_single_mlp:
                out = self.fully_connected_rot_trans(feat)
                rotation, translation = out[:, :4], out[:, 4:]
            else:
                rotation = self.fully_connected_rotation(feat)
                translation = self.fully_connected_translation(feat)
        rotation = rotation.float()
        translation = translation.float()
        if cfg.quaternion_normalization == "global":
            rotation = rotation / torch.clamp(torch.linalg.norm(rotation), min=1e-12)
        else:
            rotation = rotation / torch.clamp(
                torch.linalg.norm(rotation, dim=-1, keepdim=True), min=1e-12)
        return translation, rotation
