"""The harness's shared pieces: statistics, interval arithmetic, the trace
reader, the generators, the weights, the FLOP closed form and the roofline
counts."""

import hashlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import flops, roofline, scenes, stats, weights
from portbench.reference import geometry, model
from portbench.trace import Event, Trace

ROOT = Path(__file__).resolve().parents[2]


def test_percentile_takes_every_sample():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(10.0, 301))
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q), rel=1e-12)
    assert stats.percentile([1.0, 2.0, 3.0, 100.0], 100) == 100.0


def test_idle_share_over_a_union_of_intervals():
    busy = [(0.0, 1.0), (0.5, 2.0), (5.0, 6.0)]
    assert stats.union(busy) == [(0.0, 2.0), (5.0, 6.0)]
    assert stats.idle_share(busy, [(0.0, 4.0)]) == pytest.approx(0.5)
    # Two windows, the second idle: 3 of 4 seconds busy in the first.
    assert stats.idle_share(busy, [(0.0, 2.0), (2.5, 4.5)]) == pytest.approx(0.5)
    assert stats.idle_share(busy, [(1.5, 2.5), (4.5, 5.5)]) == pytest.approx(0.5)
    assert stats.gaps(busy, (-1.0, 7.0)) == [(-1.0, 0.0), (2.0, 5.0), (6.0, 7.0)]


def test_idle_gaps_named_by_the_innermost_host_span():
    device = [Event("k", 0.0, 1.0, 7), Event("k", 3.0, 4.0, 7)]
    host = [Event("outer", 0.0, 10.0, 1), Event("inner", 1.5, 2.5, 1),
            Event("other-thread", 0.0, 10.0, 2)]
    tr = Trace(device, host)
    gaps = dict(tr.idle_gaps((0.0, 6.0), thread=1))
    assert gaps == {"inner": pytest.approx(2.0), "outer": pytest.approx(2.0)}
    assert tr.kernel_seconds("k") == pytest.approx(2.0)


@pytest.mark.parametrize("name, beams, steps, share", [("street", 64, 2000, (0.97, 1.0)),
                                                       ("tunnel", 64, 1024, (0.90, 0.97))])
def test_generators(name, beams, steps, share):
    sensor = scenes.Sensor(beams, steps, (-24.5, 2.0) if name == "street" else (-22.5, 22.5),
                           80.0, 0.02, 0.003 if name == "street" else 0.0,
                           0.0 if name == "street" else 0.05, name == "tunnel")
    a = scenes.generate(name, sensor, 3, 2**31 + 11, "cpu")
    b = scenes.generate(name, sensor, 3, 2**31 + 11, "cpu")
    c = scenes.generate(name, sensor, 3, 2**31 + 12, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a.points, b.points))
    assert not np.array_equal(a.points[0], c.points[0])
    lo, hi = share[0] * beams * steps, share[1] * beams * steps
    assert all(lo <= n <= hi for n in a.returned)
    for p, n in zip(a.points, a.normals):
        r = np.linalg.norm(p[:, :3], axis=1)
        assert r.min() > 0.3 and r.max() < 80.0
        assert np.abs(np.linalg.norm(n, axis=1) - 1).max() < 1e-5
        assert (np.sum(n * p[:, :3], axis=1) < 0).all()           # turned to the sensor
    organized = scenes.generate(name, sensor, 1, 5, "cpu", organized=True)
    rows = organized.points[0].shape[0]
    assert rows == (beams * steps if sensor.organized else organized.returned[0])


KITTI_MODEL = json.loads((ROOT / "portbench" / "configs" / "kitti-hdl64.json").read_text())["model"]
# The networks a model block can name: the default, DeLORA's per-image
# feature extractor with the single head, and relu with the single head.
NETWORKS = {
    "default": {},
    "extractor-single-head": {"pre_feature_extraction": True, "use_single_mlp_at_output": True},
    "relu-single-head": {"activation_fct": "relu", "use_single_mlp_at_output": True},
}


def network(name, **keys):
    """The KITTI configuration's model block with the network's keys, in
    float32 -> (the block, the reference's ``Arch``, the program's model)."""
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel

    block = dict(KITTI_MODEL, **NETWORKS[name], compute_dtype="float32", **keys)
    return block, model.Arch.from_config(block), OdometryModel(ModelConfig.from_config(block))


@pytest.mark.parametrize("name", NETWORKS)
def test_weights_follow_the_initialisation_and_load_into_the_program(name):
    block, arch, net = network(name)
    specs = model.param_specs(arch)
    w = weights.make(specs, 2**31 + 3, "cpu", arch.activation)
    again = weights.make(specs, 2**31 + 3, "cpu", arch.activation)
    assert all(torch.equal(w[k], again[k]) for k in w)
    net.load_state_dict(w)                       # strict: names and shapes agree
    gain_sq = 2.0 if arch.activation == "relu" else (5 / 3) ** 2
    for s in specs:
        x = w[s.name]
        if s.init == "conv":
            std = math.sqrt(gain_sq / s.fan) / 0.87962566103423978
            assert x.abs().max() <= 2 * std * (1 + 1e-6)
            if x.numel() > 10000:
                assert x.std().item() == pytest.approx(0.8796 * std, rel=0.05)
        else:
            assert x.abs().max() <= 1 / math.sqrt(s.fan)


def _digest(chunks) -> str:
    h = hashlib.sha256()
    for chunk in chunks:
        h.update(chunk)
    return h.hexdigest()


def test_default_network_specs_and_weights_are_as_before():
    """The default network's specs (names, shapes, init, fan, order) and the
    weights a seed draws from them, bit for bit: digests recorded before the
    model block chose the network."""
    specs = model.param_specs(model.Arch())
    assert len(specs) == 30
    assert specs[0] == ("resnet.conv1.weight", (64, 8, 3, 3), "conv", 576)
    assert specs[-1] == ("fully_connected_translation.3.bias", (3,), "linear", 100)
    assert _digest([repr([tuple(s) for s in specs]).encode()]) == (
        "f23c13a3e6d49e02e61dd6c62f466489d508c015bc14f361b5906d46ad994564")
    w = weights.make(specs, 2**31 + 3, "cpu")
    assert _digest(x for k, v in w.items() for x in (k.encode(), v.numpy().tobytes())) == (
        "72378d89b854a4de63e831ad32f07b41aba21f288b556627d73605048aed8fd5")


def test_extractor_and_single_head_specs():
    specs = {s.name: s for s in model.param_specs(model.Arch(extractor=True, single_head=True))}
    chans = (4, 8, 16, 24, 32, 40)
    for k in range(5):
        assert specs[f"feature_extractor.{k}.weight"] == (
            f"feature_extractor.{k}.weight", (chans[k + 1], chans[k], 3, 3), "conv",
            chans[k + 1] * 9)
    assert specs["resnet.conv1.weight"].shape == (64, 80, 3, 3)
    widths = (1000, 512, 512, 256, 64, 7)
    for k in range(5):
        name = f"fully_connected_rot_trans.{2 * k + 1}"
        assert specs[f"{name}.weight"] == (f"{name}.weight", (widths[k + 1], widths[k]),
                                           "linear", widths[k])
        assert specs[f"{name}.bias"].shape == (widths[k + 1],)
    assert not any(n.startswith("fully_connected_rotation") for n in specs)


@pytest.mark.parametrize("normalization", ["per_row", "global"])
@pytest.mark.parametrize("name", NETWORKS)
def test_reference_pose_equals_the_program_forward(name, normalization):
    """The reference's per-row transforms against the program's forward in
    float32 on seeded weights, B=2 at 16 x 128; under a global quaternion
    norm the program normalises each row again when it builds the transform,
    so ``quaternion_normalization: global`` gives the same transforms."""
    from delora_tpu_torch.training.step import forward_pose

    block, arch, net = network(name, quaternion_normalization=normalization)
    w = weights.make(model.param_specs(arch), 2**31 + 5, "cpu", arch.activation)
    net.load_state_dict(w)
    gen = torch.Generator().manual_seed(7)
    images = [torch.rand(2, 16, 128, 4, generator=gen) * 20 for _ in range(2)]
    with torch.no_grad():
        program = forward_pose(net.eval(), *images)
        reference = model.pose(w, *images, arch)
    assert (program - reference).abs().max() < 1e-5


@pytest.mark.parametrize("key, value", [
    ("factor_fewer_resnet_channels", 2),
    ("resnet_stage_width_multipliers", [1.0, 0.5, 1.0, 1.0]),
    ("use_dropout", True),
    ("remat", True),
    ("channel_divisor", 2),
    ("learning_rate", 1e-4),
    ("activation_fct", "gelu"),
    ("compute_dtype", "float16"),
    ("quaternion_normalization", "none"),
    ("layers", [2, 2, 2]),
    ("resnet_outputs", 0),
    ("pre_feature_extraction", 1),
    ("use_single_mlp_at_output", "true"),
])
def test_model_keys_the_reference_does_not_compute_are_refused(key, value):
    with pytest.raises(ValueError, match=key):
        model.Arch.from_config(dict(KITTI_MODEL, **{key: value}))


@pytest.mark.parametrize("name", NETWORKS)
@pytest.mark.parametrize("batch, height, width", [(2, 16, 128), (1, 8, 96)])
def test_flops_closed_form_against_flop_counter(batch, height, width, name):
    from torch.utils.flop_counter import FlopCounterMode

    _, arch, _ = network(name)
    w = weights.make(model.param_specs(arch), 1, "cpu", arch.activation)
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    img = torch.rand(batch, height, width, 4)
    ops = ("convolution", "convolution_backward", "addmm", "mm")

    def counted(fn):
        with FlopCounterMode(display=False) as counter:
            fn()
        return sum(int(n) for op, n in counter.get_flop_counts()["Global"].items()
                   if str(op).split(".")[-1] in ops)

    with torch.no_grad():
        fwd = counted(lambda: model.pose(params, img, img, arch))
    assert fwd == flops.forward_flops(arch, batch, height, width)
    step = counted(lambda: model.pose(params, img, img, arch).square().sum().backward())
    assert step == flops.train_step_flops(arch, batch, height, width)


def test_published_flops():
    assert flops.train_step_flops(model.Arch(), 8, 64, 720) == 816_187_047_744


@pytest.mark.parametrize("arch, batch, height, width, forward, step", [
    (model.Arch(), 32, 64, 720, None, 3_264_748_190_976),
    (model.Arch(), 32, 64, 512, None, 2_303_313_050_880),
    (model.Arch(), 1, 64, 720, 34_078_572_536, None),
    (model.Arch(), 1, 64, 512, 24_043_175_928, None),
    (model.Arch(extractor=True, single_head=True), 1, 64, 720, 40_290_861_952, None),
    (model.Arch(extractor=True, single_head=True), 32, 64, 720, None, 3_866_224_054_272),
])
def test_published_flops_by_network(arch, batch, height, width, forward, step):
    if forward is not None:
        assert flops.forward_flops(arch, batch, height, width) == forward
    if step is not None:
        assert flops.train_step_flops(arch, batch, height, width) == step


def test_roofline_counts():
    height, width, window = 6, 10, (5, 9)
    nbytes, ops = roofline.window_match_work(2, height, width, window)
    visited = sum(1 for h in range(height) for w in range(width) for dv in range(-2, 3)
                  for du in range(-4, 5) if 0 <= h + dv < height)
    assert nbytes == 2 * height * width * 64 and ops == 3 * 2 * visited
    assert roofline.placement_work(2, 100, 4, 8, 7) == (2 * 100 * 8 + 2 * 32 * 7 * 4, 0)
    peak = roofline.peaks("NVIDIA H100 80GB HBM3")
    seconds, by = roofline.bound_s(3.35e6, 0, peak)
    assert seconds == pytest.approx(1e-6) and by == "bytes"
    assert roofline.peaks("no such card") is None


def test_reference_projection_and_matcher_agree_with_the_program():
    from delora_tpu_torch.ops.cuda.window_match import window_match_plain
    from delora_tpu_torch.ops.projection import ProjectionSpec, project_image

    cfg = {"block": {"vertical_field_of_view": [-24.5, 2.0], "vertical_cells": 16,
                     "horizontal_cells": 128}, "horizontal_field_of_view": [-179.9, 179.9]}
    spec = geometry.Spec.from_config(cfg)
    sensor = scenes.Sensor(16, 256, (-24.5, 2.0), 80.0, 0.02, 0.003, 0.0, False)
    drive = scenes.generate("street", sensor, 2, 9, "cpu")
    pspec = ProjectionSpec(16, 128, *(math.radians(v) for v in (2.0, -24.5, -179.9, 179.9)))
    images = []
    for p in drive.points:
        pts = torch.from_numpy(p[:, :3])
        ref, _, _ = geometry.range_image(pts, spec)
        prog = project_image(pts, torch.ones(len(pts), dtype=torch.bool), pspec)
        # The reference takes angles in float64, the program in float32: a
        # point within rounding of a pixel's edge may land on either side.
        assert (ref != prog).any(-1).float().mean() < 0.01
        images.append(ref)
    src = images[1][None, ..., 0:3].contiguous()
    tgt = images[0][None, ..., 0:3].contiguous()
    nrm = torch.randn_like(tgt)
    found, bx, bn = geometry.window_match(src, tgt, nrm, (5, 9))
    sq, px, pn = window_match_plain(src, tgt, nrm, (5, 9))
    assert torch.equal(found, torch.isfinite(sq))
    agree = (bx == px).all(-1)
    assert agree.float().mean() > 0.999
