"""Model forward to SE(3) transforms (the serving half of the train step)."""

from __future__ import annotations

import torch

from delora_tpu_torch import se3


def forward_pose(model, image_1: torch.Tensor, image_2: torch.Tensor,
                 quat_also: bool = False):
    """Model forward on ``[B, H, W, C]`` image pairs -> ``[B, 4, 4]``
    transforms (and the raw translation and quaternion if ``quat_also``)."""
    translation, quat = model(image_1, image_2)
    T = se3.transform_from_quat(translation, quat)
    if quat_also:
        return T, translation, quat
    return T
