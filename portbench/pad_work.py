"""The circular wrap-pad's calls and bytes in one training step, read from
the plain reference network (``reference/model.py``) run on the ``meta``
device at the step's shapes, so the network is walked in one place.

The program pads before every 3x3 convolution (the azimuth wrapped by one
column a side) and before the max-pool (wrapped by one column and the rings
padded by one row of -inf a side): a call each in the forward, and one in the
backward for each whose input carries a gradient, every one but those that
read an image. The reference pads the same tensors, so each call is the
input of a 3x3 convolution or of the max-pool there, less its padding. A call
reads its input once and writes its padded output once; the backward reads
the padded gradient and writes the input's, the same bytes. A pad runs before
autocast casts the convolution's input, so the images pad in float32 and
every later activation in the configuration's compute type.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from portbench.reference.model import IN_CHANNELS_PER_IMAGE, Arch, extract, features, param_specs

FLOAT32_BYTES = 4
COMPUTE_BYTES = {"bfloat16": 2, "float32": 4}


class PadCall(NamedTuple):
    """One forward pad of ``[batch, channels, height, width]``, and whether
    the backward pads its gradient back."""
    batch: int
    channels: int
    height: int
    width: int
    pad_w: int
    pad_h: int
    element_bytes: int
    backward: bool

    def bytes(self) -> int:
        """Read once, written once: the input and the padded output."""
        padded = (self.height + 2 * self.pad_h) * (self.width + 2 * self.pad_w)
        return self.batch * self.channels * (self.height * self.width + padded) \
            * self.element_bytes


class _PaddedInputs(TorchFunctionMode):
    """Records the input of each 3x3 convolution and of the max-pool."""

    def __init__(self):
        super().__init__()
        self.inputs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func is F.conv2d and args[1].shape[-1] == 3) or func is F.max_pool2d:
            self.inputs.append((args[0], int(func is F.max_pool2d)))
        return func(*args, **(kwargs or {}))


def pad_calls(arch: Arch, compute_dtype: str, batch: int, height: int, width: int
              ) -> List[PadCall]:
    """Every forward pad of a step, in the reference's order: the
    extractor's on image 1, on image 2, the stem's, the max-pool's, then
    each block's two."""
    w = {s.name: torch.empty(s.shape, device="meta", requires_grad=True)
         for s in param_specs(arch)}
    images = [torch.empty(batch, IN_CHANNELS_PER_IMAGE, height, width, device="meta")
              for _ in range(2)]
    with _PaddedInputs() as seen:
        if arch.extractor:
            images = [extract(w, x, arch) for x in images]
        features(w, torch.cat(images, dim=1), arch)
    calls = []
    for x, pad_h in seen.inputs:
        b, c, h, wd = x.shape
        reads_an_image = not x.requires_grad
        calls.append(PadCall(b, c, h - 2 * pad_h, wd - 2, 1, pad_h,
                             FLOAT32_BYTES if reads_an_image else COMPUTE_BYTES[compute_dtype],
                             not reads_an_image))
    return calls


class PadWork(NamedTuple):
    forward_calls: int
    backward_calls: int
    bytes: int          # forward and backward together


def train_step_pad_work(arch: Arch, compute_dtype: str, batch: int, height: int,
                        width: int) -> PadWork:
    calls = pad_calls(arch, compute_dtype, batch, height, width)
    return PadWork(len(calls), sum(c.backward for c in calls),
                   sum(c.bytes() * (1 + c.backward) for c in calls))
