"""The benchmark's count of the wrap-pad's work in a training step
(``portbench/pad_work.py``, read from the plain reference network) against
the pads the port's model makes, and the ``wrap_pad_roofline.train`` reader
on a record made by hand.

The pads are counted by wrapping the pad op the backbone calls
(``models/resnet.py::circular_pad``) inside each test: a forward call reads
its input and writes its padded output, a backward call (a hook on the
padded output's gradient) reads that gradient and writes the input's.
"""

from types import SimpleNamespace

import pytest
import torch

from delora_tpu_torch.models import resnet
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from portbench import cell, flops, pad_work, roofline
from portbench.context import record
from portbench.reference.model import Arch
from portbench.trace import Event, Trace

torch.set_num_threads(1)

B, H, W = 2, 8, 37          # an odd width: every stride-2 size rounds up

# (network, compute type, blocks a stage); every width as published.
CASES = {
    "default-bf16": (False, "bfloat16", [2, 2, 2, 2]),
    "extractor-bf16": (True, "bfloat16", [2, 2, 2, 2]),
    "default-fp32": (False, "float32", [1, 1, 1, 1]),
    "extractor-fp32": (True, "float32", [1, 1, 1, 1]),
}


def model_block(extractor, compute_dtype, layers):
    return dict(layers=layers, resnet_outputs=1000, activation_fct="tanh",
                factor_fewer_resnet_channels=1,
                resnet_stage_width_multipliers=[1.0, 1.0, 1.0, 1.0],
                pre_feature_extraction=extractor, use_single_mlp_at_output=extractor,
                quaternion_normalization="per_row", compute_dtype=compute_dtype)


def nbytes(x):
    return x.numel() * x.element_size()


@pytest.mark.parametrize("case", list(CASES))
def test_pad_work_equals_the_models_pad_calls(case, monkeypatch):
    """A forward and backward of the model on a batch: the forward and
    backward pad calls, each call's shape and element size, and the bytes
    of all of them, as ``pad_work`` gives them."""
    block = model_block(*CASES[case])
    net = OdometryModel(ModelConfig.from_config(block))
    forward, backward = [], []
    pad = resnet.circular_pad

    def counted(x, *args, **kwargs):
        out = pad(x, *args, **kwargs)
        forward.append((tuple(x.shape), x.element_size(), nbytes(x) + nbytes(out)))
        if out.requires_grad:
            out.register_hook(lambda grad: backward.append(nbytes(grad) + nbytes(x)))
        return out

    monkeypatch.setattr(resnet, "circular_pad", counted)
    gen = torch.Generator().manual_seed(0)
    image_1, image_2 = (torch.rand(B, H, W, 4, generator=gen) * 20 for _ in range(2))
    translation, quat = net(image_1, image_2)
    (translation.sum() + quat.sum()).backward()

    calls = pad_work.pad_calls(Arch.from_config(block), block["compute_dtype"], B, H, W)
    assert [((c.batch, c.channels, c.height, c.width), c.element_bytes, c.bytes())
            for c in calls] == forward
    work = pad_work.train_step_pad_work(Arch.from_config(block), block["compute_dtype"],
                                        B, H, W)
    extractor = CASES[case][0]
    # The stem, the max-pool, two a block, and the extractor's five an image.
    assert work.forward_calls == len(forward) == 2 + 2 * sum(block["layers"]) + 10 * extractor
    assert work.backward_calls == len(backward) == work.forward_calls - 1 - extractor
    assert work.bytes == sum(b for _, _, b in forward) + sum(backward)


CELLS = ("kitti-hdl64.train-b32", "kitti-hdl64-extractor.train-b32")
READER = cell.reader("wrap_pad_roofline.train")
PEAKS = roofline.peaks("NVIDIA H100 80GB HBM3")
SHAPES = {"batch": 32, "height": 64, "width": 720, "cap": 46080, "window": (5, 9)}


def traced(steps, seconds, arch):
    """A traced record of ``steps`` train steps whose wrap-pad kernels ran
    ``seconds`` in all, forward and backward alike, on the network ``arch``."""
    host = [Event("train_step", k, k + 0.5, 1) for k in range(steps)]
    device = [Event("void wrap_pad_nhwc<uint4>(...)", 0.0, seconds / 2, 7),
              Event("void wrap_pad_nhwc_grad<__nv_bfloat16, 8>(...)", 1.0, 1.0 + seconds / 2, 7),
              Event("sm90_xmma_gemm", 2.0, 3.0, 7)]
    return record(kind="train", on_card=True, trace=Trace(device, host), peaks=PEAKS,
                  shapes=dict(SHAPES), flops=flops.train_step_flops(arch, 32, 64, 720))


def test_the_roofline_reader_takes_the_network_each_cell_runs():
    """Each listed cell's network (the default one; the extractor and single
    head) is found by its FLOPs: the reading is the pads' least time a step,
    times the steps, over the pad kernels' seconds. A record of a network no
    listed cell runs, one off the card, and one with no pad kernel or no
    step read nothing."""
    import json

    spec = cell.benchmark()
    (metric,) = [m for m in spec["per_layer"] if m["name"] == "wrap_pad_roofline.train"]
    assert tuple(metric["workloads"]) == CELLS
    networks = []
    for name in CELLS:
        config = next(w["config"] for w in spec["workloads"] if w["name"] == name)
        block = json.loads((cell.PACKAGE / "configs" / f"{config}.json").read_text())["model"]
        assert block["compute_dtype"] == "bfloat16"
        networks.append(Arch.from_config(block))
    default, variant = networks
    assert not default.extractor and variant.extractor and variant.single_head

    for arch, calls in ((default, (18, 17)), (variant, (28, 26))):
        work = pad_work.train_step_pad_work(arch, "bfloat16", 32, 64, 720)
        assert (work.forward_calls, work.backward_calls) == calls
        least = work.bytes / PEAKS.hbm_bytes
        assert READER.read(traced(50, 0.1, arch)) == pytest.approx(least * 50 / 0.1 * 100)

    assert READER.read(traced(50, 0.1, Arch(blocks=(1, 1, 1, 1)))) is None
    off_card = traced(50, 0.1, variant)
    off_card.on_card = False
    assert READER.read(off_card) is None
    assert READER.read(traced(0, 0.1, variant)) is None
    no_pad = traced(50, 0.1, variant)
    no_pad.trace = Trace([e for e in no_pad.trace.device if "wrap_pad" not in e.name],
                         no_pad.trace.host)
    assert READER.read(no_pad) is None
    assert READER.read(SimpleNamespace(**{**vars(traced(50, 0.1, variant)), "kind": "serve"})) \
        is None
