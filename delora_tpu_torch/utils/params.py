"""Parameter conversion between the JAX package's Flax tree and the port.

``params_from_jax`` takes the Flax ``{'params': ...}`` tree of
``delora_tpu.models.odometry.OdometryModel`` (leaves as numpy arrays, or
anything ``np.asarray`` accepts) and returns the port's ``state_dict``: conv
kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in]. The layout (blocks
per stage, head kind, feature extractor) is read off the tree itself.
``params_to_jax`` is the exact inverse, and ``grads_to_jax`` maps a model's
parameter gradients onto the same tree, so that they can be held against
``jax.grad`` leaf by leaf.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _conv_to_torch(w) -> torch.Tensor:
    return torch.tensor(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


def _dense_to_torch(w) -> torch.Tensor:
    return torch.tensor(np.transpose(np.asarray(w, np.float32), (1, 0)))


def _head_names(p: Mapping) -> Dict[str, str]:
    """Flax MLP module -> port Sequential name."""
    if "_Mlp_1" in p:
        return {"_Mlp_0": "fully_connected_rotation", "_Mlp_1": "fully_connected_translation"}
    return {"_Mlp_0": "fully_connected_rot_trans"}


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params tree -> state_dict of ``delora_tpu_torch`` OdometryModel."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    extractor = p.get("FeatureExtractor_0", {})
    for k in range(len(extractor)):
        sd[f"feature_extractor.{k}.weight"] = _conv_to_torch(
            extractor[f"ConvCirc_{k}"]["Conv_0"]["kernel"])

    resnet = p["CircularResNet_0"]
    sd["resnet.conv1.weight"] = _conv_to_torch(resnet["ConvCirc_0"]["Conv_0"]["kernel"])
    # Stages 2-4 open with a strided block, which always has a projection
    # skip (Conv_0); the first stage's first block never does.
    stage, block, k = 1, 0, 0
    while f"BasicBlock_{k}" in resnet:
        entry = resnet[f"BasicBlock_{k}"]
        if k > 0 and "Conv_0" in entry:
            stage, block = stage + 1, 0
        prefix = f"resnet.layer{stage}.{block}"
        sd[f"{prefix}.conv1.weight"] = _conv_to_torch(entry["ConvCirc_0"]["Conv_0"]["kernel"])
        sd[f"{prefix}.conv2.weight"] = _conv_to_torch(entry["ConvCirc_1"]["Conv_0"]["kernel"])
        if "Conv_0" in entry:
            sd[f"{prefix}.downsample.0.weight"] = _conv_to_torch(entry["Conv_0"]["kernel"])
        block += 1
        k += 1
    if stage != 4:
        raise ValueError(f"expected 4 ResNet stages in the Flax tree, found {stage}")
    sd["resnet.fc.weight"] = _dense_to_torch(resnet["Dense_0"]["kernel"])
    sd["resnet.fc.bias"] = torch.tensor(np.asarray(resnet["Dense_0"]["bias"], np.float32))

    for flax_name, name in _head_names(p).items():
        tree = p[flax_name]
        for i in range(len(tree)):
            dense = tree[f"Dense_{i}"]
            # Sequential(act, Linear, act, Linear, ...): Linears at odd indices.
            sd[f"{name}.{2 * i + 1}.weight"] = _dense_to_torch(dense["kernel"])
            sd[f"{name}.{2 * i + 1}.bias"] = torch.tensor(np.asarray(dense["bias"], np.float32))
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: state_dict -> ``{'params': ...}``
    with numpy leaves."""
    out: Dict[str, Any] = {}

    def put(path, value):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def arr(t):
        return t.detach().cpu().numpy()

    blocks = sorted({m.group(1, 2) for m in (
        re.match(r"resnet\.layer(\d+)\.(\d+)\.", name) for name in state_dict) if m},
        key=lambda lb: (int(lb[0]), int(lb[1])))
    block_index = {lb: k for k, lb in enumerate(blocks)}
    heads = {"fully_connected_rotation": "_Mlp_0", "fully_connected_translation": "_Mlp_1",
             "fully_connected_rot_trans": "_Mlp_0"}
    res = ("CircularResNet_0",)
    for name, t in state_dict.items():
        if m := re.fullmatch(r"feature_extractor\.(\d+)\.weight", name):
            put(("FeatureExtractor_0", f"ConvCirc_{m[1]}", "Conv_0", "kernel"),
                np.transpose(arr(t), (2, 3, 1, 0)))
        elif name == "resnet.conv1.weight":
            put(res + ("ConvCirc_0", "Conv_0", "kernel"), np.transpose(arr(t), (2, 3, 1, 0)))
        elif m := re.fullmatch(r"resnet\.layer(\d+)\.(\d+)\.(conv1|conv2|downsample\.0)\.weight",
                               name):
            block = f"BasicBlock_{block_index[(m[1], m[2])]}"
            sub = {"conv1": ("ConvCirc_0", "Conv_0"), "conv2": ("ConvCirc_1", "Conv_0"),
                   "downsample.0": ("Conv_0",)}[m[3]]
            put(res + (block,) + sub + ("kernel",), np.transpose(arr(t), (2, 3, 1, 0)))
        elif m := re.fullmatch(r"resnet\.fc\.(weight|bias)", name):
            put(res + ("Dense_0", "kernel" if m[1] == "weight" else "bias"),
                arr(t).T if m[1] == "weight" else arr(t))
        elif m := re.fullmatch(r"(fully_connected_\w+)\.(\d+)\.(weight|bias)", name):
            put((heads[m[1]], f"Dense_{(int(m[2]) - 1) // 2}",
                 "kernel" if m[3] == "weight" else "bias"),
                arr(t).T if m[3] == "weight" else arr(t))
        else:
            raise KeyError(f"unexpected state_dict entry {name!r}")
    return {"params": out}


def grads_to_jax(model: torch.nn.Module) -> Dict[str, Any]:
    """The gradients of ``model``'s parameters as a Flax ``{'params': ...}``
    tree with numpy leaves; zeros where a parameter has no gradient."""
    return params_to_jax({
        name: p.grad if p.grad is not None else torch.zeros_like(p)
        for name, p in model.named_parameters()
    })
