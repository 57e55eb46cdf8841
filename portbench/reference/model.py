"""Plain PyTorch reference of DeLORA's odometry network, functional, float32.

The network a configuration's ``model`` block names, as DeLORA publishes it
(``leggedrobotics/delora``, ``src/models/model.py``, ``resnet_modified.py``
and ``model_parts.py``):

- the two range images ``[B, H, W, 4]`` (xyz and range), each through a
  shared feature extractor when ``pre_feature_extraction`` is on
  (``model.py:30-45``: five bias-free 3x3 convolutions at full resolution
  that wrap the azimuth and zero-pad the rings as the backbone's do,
  4 -> 8 -> 16 -> 24 -> 32 -> 40 channels, each followed by the activation),
  then stacked channel-wise, image 1 first (``model.py:98``);
- a ResNet-18 without normalisation whose convolutions wrap the azimuth (W)
  circularly and zero-pad the rings (H), strides (1,2) in the stem, the
  max-pool and stages 2 and 3 and (2,2) in stage 4, a global mean and ``fc``
  to 1000 features;
- two heads (``model.py:74-87``: act, 1000 -> 100, act, 100 -> 4 rotation
  and -> 3 translation), or with ``use_single_mlp_at_output`` one
  activation-first head 1000 -> 512 -> 512 -> 256 -> 64 -> 7
  (``model.py:59-72``) whose first 4 outputs are the rotation and the last 3
  the translation (``model.py:108-109``);
- the rotation a quaternion (x, y, z, w) normalised per row.

``Arch.from_config`` takes each key of the model block it computes
(``COMPUTED``) and refuses any other key away from the value the reference
assumes (``ASSUMED``), naming it. ``quaternion_normalization: global``
(``model.py:114``, one norm over the whole batch) is accepted: the program
normalises each quaternion again when it builds a transform, so its
transforms equal the per-row ones (``portbench/tests/test_portbench_parts.py``).

Weights are a dict keyed as the program's ``state_dict``, so the benchmark
hands the same tensors to both sides. ``quant`` runs every convolution and
linear on inputs and weights rounded to a lower precision (the control);
``autocast`` runs the network in bfloat16 as the configuration states, which
the comparison uses only to gauge how far rounding alone moves each answer.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

STAGE_STRIDES = ((1, 1), (1, 2), (1, 2), (2, 2))
STAGE_WIDTHS = (64, 128, 256, 512)
HEAD_WIDTH = 100
IN_CHANNELS_PER_IMAGE = 4
EXTRACTOR_WIDTHS = (8, 16, 24, 32, 40)
SINGLE_HEAD_WIDTHS = (512, 512, 256, 64, 7)


def _whole(value) -> bool:
    return isinstance(value, int) and not isinstance(value, bool) and value > 0


# The model keys the reference computes, each with the test of a value it takes.
COMPUTED = {
    "layers": lambda v: (isinstance(v, list) and len(v) == len(STAGE_WIDTHS)
                         and all(_whole(b) for b in v)),
    "resnet_outputs": _whole,
    "activation_fct": lambda v: v in ("tanh", "relu"),
    "compute_dtype": lambda v: v in ("bfloat16", "float32"),
    "pre_feature_extraction": lambda v: isinstance(v, bool),
    "use_single_mlp_at_output": lambda v: isinstance(v, bool),
    "quaternion_normalization": lambda v: v in ("per_row", "global"),
}
# The model keys the reference does not compute, at the value it assumes;
# any other value, or any key in neither table, is refused.
ASSUMED = {"factor_fewer_resnet_channels": 1,
           "resnet_stage_width_multipliers": [1.0, 1.0, 1.0, 1.0],
           "use_dropout": False, "remat": False}


class Arch(NamedTuple):
    blocks: Tuple[int, ...] = (2, 2, 2, 2)
    outputs: int = 1000
    activation: str = "tanh"
    extractor: bool = False      # pre_feature_extraction
    single_head: bool = False    # use_single_mlp_at_output

    @classmethod
    def from_config(cls, model: Dict) -> "Arch":
        for key, value in model.items():
            if key in COMPUTED:
                if not COMPUTED[key](value):
                    raise ValueError(f"the reference does not compute {key}={value!r}")
            elif key not in ASSUMED:
                raise ValueError(f"the reference does not compute the model key {key!r}")
            elif value != ASSUMED[key]:
                raise ValueError(f"the reference computes {key}={ASSUMED[key]!r}, the cell "
                                 f"asks {value!r}")
        return cls(tuple(model["layers"]), model["resnet_outputs"], model["activation_fct"],
                   model.get("pre_feature_extraction", False),
                   model.get("use_single_mlp_at_output", False))


class ParamSpec(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    init: str           # "conv": truncated normal on fan-out; "linear": U(+-1/sqrt(fan-in))
    fan: int


def param_specs(arch: Arch) -> List[ParamSpec]:
    """Every weight, in a fixed order, named as the program names it."""
    specs: List[ParamSpec] = []

    def conv(name, cout, cin, kh, kw):
        specs.append(ParamSpec(name, (cout, cin, kh, kw), "conv", cout * kh * kw))

    def linear(name, fin, fout):
        specs.append(ParamSpec(f"{name}.weight", (fout, fin), "linear", fin))
        specs.append(ParamSpec(f"{name}.bias", (fout,), "linear", fin))

    cin = IN_CHANNELS_PER_IMAGE
    if arch.extractor:
        for k, width in enumerate(EXTRACTOR_WIDTHS):
            conv(f"feature_extractor.{k}.weight", width, cin, 3, 3)
            cin = width
    conv("resnet.conv1.weight", STAGE_WIDTHS[0], 2 * cin, 3, 3)
    cin = STAGE_WIDTHS[0]
    for s, (width, stride, blocks) in enumerate(zip(STAGE_WIDTHS, STAGE_STRIDES, arch.blocks)):
        for b in range(blocks):
            prefix = f"resnet.layer{s + 1}.{b}"
            conv(f"{prefix}.conv1.weight", width, cin, 3, 3)
            conv(f"{prefix}.conv2.weight", width, width, 3, 3)
            if b == 0 and (stride != (1, 1) or cin != width):
                conv(f"{prefix}.downsample.0.weight", width, cin, 1, 1)
            cin = width
    linear("resnet.fc", STAGE_WIDTHS[3], arch.outputs)
    for head, widths in heads(arch):
        fin = arch.outputs
        for k, width in enumerate(widths):
            linear(f"{head}.{2 * k + 1}", fin, width)
            fin = width
    return specs


def heads(arch: Arch) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """Each head's name and the widths of its linears, in order."""
    if arch.single_head:
        return (("fully_connected_rot_trans", SINGLE_HEAD_WIDTHS),)
    return (("fully_connected_rotation", (HEAD_WIDTH, 4)),
            ("fully_connected_translation", (HEAD_WIDTH, 3)))


def quantize_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to e4m3's largest finite value (448), back in float32."""
    amax = x.detach().abs().max().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def control_quant(compute_dtype: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding of the control: the precision next below the one the
    configuration states for the network (float8 e4m3 below bfloat16)."""
    if compute_dtype != "bfloat16":
        raise ValueError(f"no control precision below {compute_dtype!r}")
    return quantize_e4m3


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    if quant is None:
        return x
    # Straight-through: the rounding carries no gradient of its own.
    return x + (quant(x) - x).detach()


def _conv(x, w, stride, quant: Quant):
    """Bias-free convolution; a 3x3 wraps the azimuth by one column and pads
    the rings with zeros."""
    if w.shape[-1] == 3:
        x = torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)
        padding = (1, 0)
    else:
        padding = (0, 0)
    return F.conv2d(_q(x, quant), _q(w, quant), stride=stride, padding=padding)


def _linear(x, w, b, quant: Quant):
    return F.linear(_q(x, quant), _q(w, quant), b)


def _act(name: str):
    return torch.tanh if name == "tanh" else torch.relu


def features(w: Dict[str, torch.Tensor], x: torch.Tensor, arch: Arch,
             quant: Quant = None) -> torch.Tensor:
    """The stem's input ``[B, C, H, W]`` -> ``[B, outputs]``: the backbone
    and ``fc``."""
    act = _act(arch.activation)
    x = act(_conv(x, w["resnet.conv1.weight"], (1, 2), quant))
    x = torch.cat([x[..., -1:], x, x[..., :1]], dim=-1)
    x = F.pad(x, (0, 0, 1, 1), value=-math.inf)
    x = F.max_pool2d(x, 3, stride=(1, 2))
    for s, (stride, blocks) in enumerate(zip(STAGE_STRIDES, arch.blocks)):
        for b in range(blocks):
            prefix = f"resnet.layer{s + 1}.{b}"
            st = stride if b == 0 else (1, 1)
            out = act(_conv(x, w[f"{prefix}.conv1.weight"], st, quant))
            out = _conv(out, w[f"{prefix}.conv2.weight"], (1, 1), quant)
            down = w.get(f"{prefix}.downsample.0.weight")
            identity = x if down is None else _conv(x, down, st, quant)
            x = act(out + identity)
    return _linear(x.mean(dim=(2, 3)), w["resnet.fc.weight"], w["resnet.fc.bias"], quant)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (x, y, z, w) -> rotation matrices."""
    x, y, z, s = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - s * z), 2 * (x * z + s * y)], -1),
        torch.stack([2 * (x * y + s * z), 1 - 2 * (x * x + z * z), 2 * (y * z - s * x)], -1),
        torch.stack([2 * (x * z - s * y), 2 * (y * z + s * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def transform(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Translations ``[B, 3]`` and quaternions ``[B, 4]`` (any norm) ->
    ``[B, 4, 4]`` transforms."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    T = torch.zeros(q.shape[0], 4, 4, dtype=q.dtype, device=q.device)
    T[:, :3, :3] = quat_to_rotmat(q)
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    return T


def extract(w: Dict[str, torch.Tensor], x: torch.Tensor, arch: Arch,
            quant: Quant = None) -> torch.Tensor:
    """One image ``[B, 4, H, W]`` -> ``[B, 40, H, W]``: the feature
    extractor, each convolution followed by the activation."""
    act = _act(arch.activation)
    for k in range(len(EXTRACTOR_WIDTHS)):
        x = act(_conv(x, w[f"feature_extractor.{k}.weight"], (1, 1), quant))
    return x


def pose(w: Dict[str, torch.Tensor], image_1: torch.Tensor, image_2: torch.Tensor,
         arch: Arch, quant: Quant = None, autocast: Optional[torch.dtype] = None,
         channels_last: bool = False) -> torch.Tensor:
    """Two ``[B, H, W, 4]`` range images -> ``[B, 4, 4]`` transforms;
    ``autocast`` runs the network under ``torch.autocast`` in that type
    (the transform is built in float32); ``channels_last`` lays the
    activations out NHWC, which takes other convolution kernels."""
    layout = torch.channels_last if channels_last else torch.contiguous_format
    images = [x.permute(0, 3, 1, 2).contiguous(memory_format=layout)
              for x in (image_1, image_2)]
    with torch.autocast(image_1.device.type, dtype=autocast or torch.float32,
                        enabled=autocast is not None):
        if arch.extractor:
            images = [extract(w, x, arch, quant) for x in images]
        feat = features(w, torch.cat(images, dim=1), arch, quant)
        act = _act(arch.activation)
        out = []
        for name, widths in heads(arch):
            h = feat
            for k in range(len(widths)):
                h = _linear(act(h), w[f"{name}.{2 * k + 1}.weight"],
                            w[f"{name}.{2 * k + 1}.bias"], quant)
            out.append(h)
        if arch.single_head:
            q, t = out[0][:, :4], out[0][:, 4:]
        else:
            q, t = out
    return transform(t.float(), q.float())
