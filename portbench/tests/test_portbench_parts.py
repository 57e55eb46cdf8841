"""The harness's shared pieces: statistics, interval arithmetic, the trace
reader, the generators, the weights, the FLOP closed form and the roofline
counts."""

import math

import numpy as np
import pytest
import torch

from portbench import flops, roofline, scenes, stats, weights
from portbench.reference import geometry, model
from portbench.trace import Event, Trace


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


def test_weights_follow_the_initialisation_and_load_into_the_program():
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel

    arch = model.Arch()
    specs = model.param_specs(arch)
    w = weights.make(specs, 2**31 + 3, "cpu")
    again = weights.make(specs, 2**31 + 3, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    net = OdometryModel(ModelConfig())
    net.load_state_dict(w)                       # strict: names and shapes agree
    for s in specs:
        x = w[s.name]
        if s.init == "conv":
            std = math.sqrt((5 / 3) ** 2 / s.fan) / 0.87962566103423978
            assert x.abs().max() <= 2 * std * (1 + 1e-6)
            if x.numel() > 10000:
                assert x.std().item() == pytest.approx(0.8796 * std, rel=0.05)
        else:
            assert x.abs().max() <= 1 / math.sqrt(s.fan)


@pytest.mark.parametrize("batch, height, width", [(2, 16, 128), (1, 8, 96)])
def test_flops_closed_form_against_flop_counter(batch, height, width):
    from torch.utils.flop_counter import FlopCounterMode

    arch = model.Arch()
    w = weights.make(model.param_specs(arch), 1, "cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    img = torch.rand(batch, height, width, 4)
    ops = ("convolution", "convolution_backward", "addmm", "mm")

    def counted(fn):
        with FlopCounterMode(display=False) as counter:
            fn()
        return sum(int(n) for op, n in counter.get_flop_counts()["Global"].items()
                   if str(op).split(".")[-1] in ops)

    fwd = counted(lambda: model.features(params, torch.cat([img, img], -1).permute(0, 3, 1, 2),
                                         arch).detach())
    # The heads' four linears are counted by the closed form and run in pose().
    heads = 2 * batch * arch.outputs * model.HEAD_WIDTH * 2 + 2 * batch * model.HEAD_WIDTH * 7
    assert fwd + heads == flops.forward_flops(arch, batch, height, width)
    step = counted(lambda: model.pose(params, img, img, arch).square().sum().backward())
    assert step == flops.train_step_flops(arch, batch, height, width)


def test_published_flops():
    assert flops.train_step_flops(model.Arch(), 8, 64, 720) == 816_187_047_744


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
