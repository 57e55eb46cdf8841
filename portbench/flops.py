"""The network's floating-point operations, in closed form from its shapes.

Two operations a multiply-add of every convolution and linear layer (what
``torch.utils.flop_counter.FlopCounterMode`` counts for ``convolution``,
``addmm`` and ``mm``): the feature extractor's convolutions on each image
when the configuration has it, the backbone, ``fc`` and the heads. A
training step adds the backward pass, twice the forward's operations, less
the input gradient of each layer that reads an image: the images carry none.
Activations, pooling and the mean are not counted.
"""

from __future__ import annotations

from typing import List

from portbench.reference.model import (
    EXTRACTOR_WIDTHS,
    IN_CHANNELS_PER_IMAGE,
    STAGE_STRIDES,
    STAGE_WIDTHS,
    Arch,
    heads,
)


def _out(size: int, stride: int) -> int:
    # A 3x3 with one cell of padding (or wrap) a side, and a 1x1 without,
    # give the same output size.
    return (size - 1) // stride + 1


def layer_flops(arch: Arch, batch: int, height: int, width: int) -> List[int]:
    """Forward operations of each convolution and linear, in order: the
    extractor's on image 1, then on image 2, then the rest."""
    out: List[int] = []
    cin = IN_CHANNELS_PER_IMAGE
    if arch.extractor:
        extractor = []
        for cout in EXTRACTOR_WIDTHS:
            extractor.append(2 * batch * cout * height * width * cin * 9)
            cin = cout
        out += extractor * 2
    h, w = height, _out(width, 2)
    out.append(2 * batch * STAGE_WIDTHS[0] * h * w * 2 * cin * 9)
    w = _out(w, 2)                                  # max-pool, stride (1, 2)
    cin = STAGE_WIDTHS[0]
    for width_c, (sh, sw), blocks in zip(STAGE_WIDTHS, STAGE_STRIDES, arch.blocks):
        for b in range(blocks):
            st = (sh, sw) if b == 0 else (1, 1)
            ho, wo = _out(h, st[0]), _out(w, st[1])
            out.append(2 * batch * width_c * ho * wo * cin * 9)
            out.append(2 * batch * width_c * ho * wo * width_c * 9)
            if b == 0 and (st != (1, 1) or cin != width_c):
                out.append(2 * batch * width_c * ho * wo * cin)
            h, w, cin = ho, wo, width_c
    out.append(2 * batch * STAGE_WIDTHS[3] * arch.outputs)
    for _, widths in heads(arch):
        fin = arch.outputs
        for fout in widths:
            out.append(2 * batch * fin * fout)
            fin = fout
    return out


def forward_flops(arch: Arch, batch: int, height: int, width: int) -> int:
    return sum(layer_flops(arch, batch, height, width))


def train_step_flops(arch: Arch, batch: int, height: int, width: int) -> int:
    layers = layer_flops(arch, batch, height, width)
    reads_an_image = (0, len(EXTRACTOR_WIDTHS)) if arch.extractor else (0,)
    return 3 * sum(layers) - sum(layers[i] for i in reads_an_image)
