"""Weights in the original DeLORA checkpoint layout (``.pth``).

The reference trainer saves ``{epoch, model_state_dict,
optimizer_state_dict, loss, parameters}`` with ``torch.save``, and its
tester and ROS node load that file; the JAX package reads and writes the
same layout (``delora_tpu/utils/torch_import.py``), converting between it and
its Flax tree. The port's ``OdometryModel`` already uses DeLORA's module
names (``resnet.layer1.0.conv1.weight``, ``fully_connected_rotation.1.weight``,
``fully_connected_rot_trans.{1,3,5,7,9}`` for the single-MLP head) and
layouts (conv OIHW, linear [out, in]), so here the state_dict passes as it
is: every name and shape is checked against the model the config describes,
and a missing, unexpected or misshapen entry raises; none is dropped.

Files are written as the reference's were, with
``_use_new_zipfile_serialization=False`` for hosts with an old PyTorch. Such
weights are served with ``StreamingOdometry(config,
params=load_reference_checkpoint(path))``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from delora_tpu_torch.config import default_settings
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel

# The config keys that decide the model's names and shapes.
_MODEL_KEYS = ("resnet_outputs", "layers", "factor_fewer_resnet_channels", "activation_fct",
               "pre_feature_extraction", "use_single_mlp_at_output",
               "resnet_stage_width_multipliers")


def check_layout(state_dict: Mapping[str, torch.Tensor],
                 config: Optional[Mapping[str, Any]] = None) -> None:
    """Raise unless ``state_dict`` holds exactly the weights of the model
    that ``config`` describes (its model keys over the defaults), each with
    its shape."""
    settings = default_settings()
    settings.update({k: config[k] for k in _MODEL_KEYS if config and k in config})
    with torch.device("meta"):                  # names and shapes, no storage
        model = OdometryModel(ModelConfig.from_config(settings))
    layout = {name: value.shape for name, value in model.state_dict().items()}
    missing = sorted(set(layout) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(layout))
    if missing or unexpected:
        raise KeyError(f"state_dict does not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")
    wrong = {k: (tuple(state_dict[k].shape), tuple(s)) for k, s in layout.items()
             if tuple(state_dict[k].shape) != tuple(s)}
    if wrong:
        raise ValueError(f"state_dict shapes (found, expected): {wrong}")


def load_reference_checkpoint(path: str, config: Optional[Mapping[str, Any]] = None
                              ) -> Dict[str, torch.Tensor]:
    """A DeLORA ``.pth`` file (or a bare state_dict file) -> the port's
    state_dict, float32 on the CPU. The layout is checked against ``config``,
    else against the file's own ``parameters``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = payload.get("model_state_dict", payload)
    if config is None:
        config = payload.get("parameters") or {}
    check_layout(state_dict, config)
    return {k: v.to(torch.float32) for k, v in state_dict.items()}


def save_reference_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                              config: Optional[Mapping[str, Any]] = None, epoch: int = 0,
                              loss: float = 0.0) -> None:
    """Write ``state_dict`` (checked against ``config``) in the DeLORA
    layout, with ``config`` as its ``parameters``."""
    check_layout(state_dict, config)
    torch.save({
        "epoch": int(epoch),
        "model_state_dict": {k: v.detach().cpu().contiguous() for k, v in state_dict.items()},
        "optimizer_state_dict": {},
        "loss": float(loss),
        "parameters": dict(config or {}),
    }, path, _use_new_zipfile_serialization=False)
