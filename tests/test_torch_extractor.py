"""DeLORA's per-image feature extractor and single head in the port, against
the benchmark's plain PyTorch reference (``portbench/reference/model.py``)
on the benchmark's seeded weights (``portbench/weights.py``), in float32 on
the CPU.

The reference is written from DeLORA's published model, apart from the
port, so it is the yardstick for the configuration the benchmark's
``kitti-hdl64-extractor`` cell runs at full size on the card.
"""

import pytest
import torch
import torch.nn.functional as F

from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from portbench import weights
from portbench.reference import model as reference

torch.set_num_threads(1)

SEED = 2**31 + 25

# Both sides in float32 run the same convolutions and linears on the same
# weights, in orders that may differ (the port's modules against functional
# calls), so they agree to float32 rounding: about 1e-6 of a tensor's largest
# magnitude at most (measured: bit-equal on these inputs). 1e-4 of it leaves
# that a hundredfold room. bfloat16's 8-bit significand moves the worst
# gradient by a tenth of its largest magnitude or more (measured 0.17 on the
# port, 0.17 on the reference), a thousand times the tolerance.
TOLERANCE = 1e-4

# name -> the network's keys, the images' [B, H, W], and whether the case
# also shows that bfloat16 on either side misses the tolerance. The relu
# case keeps every width but one block a stage, at a size that keeps it under
# a second.
NETWORKS = {
    "tanh-per_row": (dict(activation_fct="tanh", quaternion_normalization="per_row"),
                     (2, 16, 64), True),
    "relu-global": (dict(activation_fct="relu", quaternion_normalization="global",
                         layers=[1, 1, 1, 1]), (1, 8, 32), False),
}


def model_block(name, compute_dtype="float32"):
    block = dict(layers=[2, 2, 2, 2], resnet_outputs=1000, factor_fewer_resnet_channels=1,
                 resnet_stage_width_multipliers=[1.0, 1.0, 1.0, 1.0],
                 pre_feature_extraction=True, use_single_mlp_at_output=True,
                 compute_dtype=compute_dtype)
    return {**block, **NETWORKS[name][0]}


def program(block, w):
    """The port's model on the seeded weights, loaded strictly."""
    net = OdometryModel(ModelConfig.from_config(block))
    net.load_state_dict(w)
    return net


def images(shape=(2, 16, 64), seed=7):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(2):
        img = torch.randn(*shape, 4, generator=gen) * 10
        img[..., 3] = img[..., :3].norm(dim=-1)
        img[torch.rand(shape, generator=gen) < 0.2] = 0.0      # empty pixels
        out.append(img)
    return out


def reference_outputs(w, image_1, image_2, arch, normalization, autocast=None):
    """The reference network's translation and normalised quaternion: its
    extractor, backbone and single head (``reference.pose`` up to the
    transform)."""
    maps = [x.permute(0, 3, 1, 2).contiguous() for x in (image_1, image_2)]
    act = torch.tanh if arch.activation == "tanh" else torch.relu
    with torch.autocast("cpu", dtype=autocast or torch.float32, enabled=autocast is not None):
        maps = [reference.extract(w, x, arch) for x in maps]
        h = reference.features(w, torch.cat(maps, dim=1), arch)
        ((name, widths),) = reference.heads(arch)
        for k in range(len(widths)):
            h = F.linear(act(h), w[f"{name}.{2 * k + 1}.weight"], w[f"{name}.{2 * k + 1}.bias"])
    q, t = h[:, :4].float(), h[:, 4:].float()
    norm = q.norm() if normalization == "global" else q.norm(dim=-1, keepdim=True)
    return t, q / norm


def objective(translation, quat):
    """A fixed scalar of both outputs, whose gradient reaches every weight."""
    gen = torch.Generator().manual_seed(3)
    return ((translation * torch.randn(translation.shape, generator=gen)).sum()
            + (quat * torch.randn(quat.shape, generator=gen)).sum())


def outputs_and_grads(fn, params):
    translation, quat = fn()
    grads = torch.autograd.grad(objective(translation, quat), params)
    return translation.detach(), quat.detach(), grads


def gap(a, b):
    """Largest difference over the reference's largest magnitude."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def worst_gap(subject, ref, names):
    (t, q, g), (rt, rq, rg) = subject, ref
    gaps = {"translation": gap(t, rt), "quaternion": gap(q, rq)}
    gaps.update({name: gap(a, b) for name, a, b in zip(names, g, rg)})
    return max(gaps.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("name", list(NETWORKS))
def test_extractor_and_single_head_equal_the_plain_reference(name):
    """Translation, quaternion and every weight's gradient of a fixed scalar
    of both, float32 against float32 within ``TOLERANCE``; the port under
    bfloat16 autocast, and the reference under it, each miss it."""
    _, shape, rounding = NETWORKS[name]
    block = model_block(name)
    arch = reference.Arch.from_config(block)
    w = weights.make(reference.param_specs(arch), SEED, "cpu", arch.activation)
    names = list(w)
    image_1, image_2 = images(shape)

    net = program(block, w)
    params = [dict(net.named_parameters())[k] for k in names]
    ours = outputs_and_grads(lambda: net(image_1, image_2), params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref_params = [leaves[k] for k in names]
    normalization = block["quaternion_normalization"]
    ref = outputs_and_grads(
        lambda: reference_outputs(leaves, image_1, image_2, arch, normalization), ref_params)
    assert len(names) == len(list(net.parameters()))
    worst = worst_gap(ours, ref, names)
    assert worst[1] <= TOLERANCE, worst
    if not rounding:
        return

    bf16 = program(model_block(name, "bfloat16"), w)
    bf16_params = [dict(bf16.named_parameters())[k] for k in names]
    rounded = outputs_and_grads(lambda: bf16(image_1, image_2), bf16_params)
    assert worst_gap(rounded, ref, names)[1] > 10 * TOLERANCE
    rounded_ref = outputs_and_grads(
        lambda: reference_outputs(leaves, image_1, image_2, arch, normalization,
                                  autocast=torch.bfloat16), ref_params)
    assert worst_gap(rounded_ref, ours, names)[1] > 10 * TOLERANCE
