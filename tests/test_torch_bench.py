"""The port's bench (``delora_tpu_torch/bench.py``, ``cli bench``) against the
root ``bench.py`` and the JAX package, on the CPU at ``BENCH_SMOKE`` shapes
(16x64, N = 4,096, 3,000 valid, B = 2).

The input draw is held against the reference's own ``scan()``, taken out of
``bench.py`` by its syntax tree and run; the six stacked artifact tables and
the gathered ``FullyCachedBatch`` against the JAX package's
``scan_artifacts_np`` (numpy route) and a JAX gather, bit for bit. One fp32
headline step of the full-width model (params drawn with numpy and carried in
by ``params_from_jax``) is held against ``jax.value_and_grad`` of
``loss_and_metrics_fullcached`` plus optax Adam with the tolerances of
``tests/test_torch_step.py``: loss and metrics rtol 1e-5 (``visible_pixels``
within one point), gradients rtol 1e-4 / atol 1e-5 x max|g| a leaf; the
updated params equal optax's Adam fed the port's gradients within rtol 1e-6 /
atol 1e-6 x max|p|. (Against optax fed JAX's gradients they differ more: a
first Adam step moves an element by lr x g / (|g| + 1e-8), so where a
gradient element is near 1e-8 its last-bit difference between the frameworks
is a visible share of lr; measured 0.42 lr on 2 of 36,864 elements of a
first-stage convolution.)

``cli bench 2 2 --device cpu`` runs every section with the headline's unit of
steps cut from 32 to 1 (2 warm-up and 5 timed steps: the full 224 would take
a minute here) and a deadline that skips every diagnostic; the diagnostics
run on their own. The FLOP count is held against ``chip_smoke.py``'s closed
form over the model's ``Conv2d`` and ``Linear`` shapes read by forward hooks.
"""

import ast
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from delora_tpu.losses.icp import IcpLossConfig as JaxIcpLossConfig
from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu.ops.projection import ProjectionSpec as JaxProjectionSpec
from delora_tpu.ops.projection_host import scan_artifacts_np as jax_scan_artifacts_np
from delora_tpu.training import step as jstep
from delora_tpu.training.state import make_optimizer as jax_make_optimizer
from delora_tpu_torch import bench
from delora_tpu_torch.losses.icp import IcpLossConfig
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.training.state import make_optimizer
from delora_tpu_torch.training.step import StepConfig, train_step
from delora_tpu_torch.utils.params import grads_to_jax, params_from_jax, params_to_jax
from chip_smoke import counted_flops
from tests.test_torch_step import assert_metrics_close, assert_trees_close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B = 2
SHAPES = bench.bench_shapes(B, smoke=True)
LR = 1e-5


def reference_bench_source():
    return ast.parse((ROOT / "bench.py").read_text(), "bench.py")


@pytest.fixture(scope="module")
def scans():
    return bench.draw_scans(SHAPES)


@pytest.fixture(scope="module")
def smoke_bench():
    return bench.Bench(B, 1, "cpu", smoke=True)


def test_smoke_shapes_are_the_reference_s():
    """``H, W, N, VALID = 16, 64, 4096, 3000`` under ``BENCH_SMOKE``, and
    the full shapes of bench.py:82-85."""
    smoke = [node for node in ast.walk(reference_bench_source())
             if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple)
             and [getattr(t, "id", None) for t in node.targets[0].elts] == ["H", "W", "N", "VALID"]]
    assert len(smoke) == 1
    assert SHAPES[1:] == tuple(ast.literal_eval(smoke[0].value))
    assert bench.bench_shapes(8, smoke=False) == (8, 64, 720, 131072, 110000)


def test_input_draw_is_the_reference_s(scans):
    """The reference's nested ``scan()`` (bench.py:108-117), run twice on
    ``default_rng(0)``, gives the port's draw bit for bit."""
    fn = next(node for node in ast.walk(reference_bench_source())
              if isinstance(node, ast.FunctionDef) and node.name == "scan")
    namespace = {"np": np, "rng": np.random.default_rng(0), "B": B, "N": SHAPES.points,
                 "VALID": SHAPES.valid}
    exec(compile(ast.Module([fn], []), "bench.py", "exec"), namespace)
    reference = (*namespace["scan"](), *namespace["scan"]())
    assert len(scans) == len(reference) == 6
    for ours, theirs in zip(scans, reference):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def jax_tables(scans):
    """bench.py:129-130 and :168-175 with the JAX package's artifacts."""
    spec = JaxProjectionSpec(*bench.projection_spec(SHAPES))
    p1, n1, v1, p2, n2, v2 = scans
    arts = ([jax_scan_artifacts_np(p1[b], n1[b], v1[b], spec, use_native=False)
             for b in range(B)]
            + [jax_scan_artifacts_np(p2[b], n2[b], v2[b], spec, use_native=False)
               for b in range(B)])
    return (jnp.asarray(np.stack([a.image for a in arts])),
            jnp.asarray(np.stack([a.normal_image for a in arts])),
            jnp.asarray(np.asarray([a.mean_range for a in arts], np.float32)),
            jnp.asarray(np.stack([a.src_points for a in arts])),
            jnp.asarray(np.stack([a.src_normals for a in arts])),
            jnp.asarray(np.stack([a.src_valid for a in arts])))


@pytest.fixture(scope="module")
def tables(scans):
    return bench.artifact_tables(scans, bench.projection_spec(SHAPES)), jax_tables(scans)


def test_tables_equal_jax(tables):
    ours, theirs = tables
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_gathered_batch_equals_jax(tables):
    ours, theirs = tables
    t = np.arange(B, dtype=np.int32)
    s = t + B
    img, nimg, mr, pts, nrm, val = theirs
    reference = jstep.FullyCachedBatch(img[t], nimg[t], mr[t], img[s], pts[s], nrm[s], val[s],
                                       mr[s])
    tt = torch.arange(B)
    batch = bench.gather_batch(tuple(map(torch.from_numpy, ours)), tt, tt + B)
    assert type(batch).__name__ == "FullyCachedBatch" and batch._fields == reference._fields
    for a, b in zip(batch, reference):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_first_fp32_headline_step_matches_jax(tables):
    """One fp32 headline step (gather, ``train_step``, Adam at lr 1e-5) of the
    full-width model against ``jax.value_and_grad`` plus optax Adam."""
    ours, theirs = tables
    jspec = JaxProjectionSpec(*bench.projection_spec(SHAPES))
    jmodel = JaxOdometryModel(JaxModelConfig(compute_dtype=jnp.float32))
    x = jnp.zeros((1, SHAPES.height, SHAPES.width, 4), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(0)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.normal(size=s.shape) * 0.5 / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map(draw, shapes)
    t = np.arange(B)
    img, nimg, mr, pts, nrm, val = theirs
    jbatch = jstep.FullyCachedBatch(img[t], nimg[t], mr[t], img[t + B], pts[t + B],
                                    nrm[t + B], val[t + B], mr[t + B])
    jcfg = jstep.StepConfig(proj=jspec, icp=JaxIcpLossConfig())
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_and_metrics_fullcached(jmodel.apply, p, jbatch, jcfg,
                                                    jax.random.PRNGKey(4)), has_aux=True))
    (loss_ref, (metrics_ref, _)), grads_ref = grad_fn(params)

    model = OdometryModel(ModelConfig(compute_dtype=torch.float32))
    model.load_state_dict(params_from_jax(params))
    optimizer, _ = make_optimizer({"learning_rate": LR}, model.parameters(), B)
    cfg = StepConfig(proj=bench.projection_spec(SHAPES), icp=IcpLossConfig())
    tt = torch.arange(B)
    metrics = train_step(model, optimizer,
                         bench.gather_batch(tuple(map(torch.from_numpy, ours)), tt, tt + B), cfg)

    np.testing.assert_allclose(metrics["loss"].item(), float(loss_ref), rtol=1e-5)
    assert_metrics_close(metrics_ref, metrics)
    assert float(metrics_ref["num_po2pl_pairs"]) > 5
    assert_trees_close(grads_ref, grads_to_jax(model), rtol=1e-4, atol_scale=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(jstep.optax_global_norm(grads_ref)), rtol=1e-4)
    # Adam: optax's first update fed the port's gradients.
    grads = grads_to_jax(model)
    tx = jax_make_optimizer({"learning_rate": LR}, B)
    updates, _ = tx.update(grads, tx.init(params), params)
    assert_trees_close(optax.apply_updates(params, updates), params_to_jax(model.state_dict()),
                       rtol=1e-6, atol_scale=1e-6)


def test_flops_per_step_is_the_closed_form(smoke_bench):
    """FlopCounterMode's count of the model's convolutions and linears in one
    headline step equals ``chip_smoke.closed_form_flops`` over the shapes the
    step's Conv2d and Linear layers saw: forward 2 x MACs, backward twice
    that less the first layer's input gradient (the images carry none)."""
    flops, closed = counted_flops(smoke_bench)
    assert flops == closed > 0


def test_diagnostics_run_or_say_they_are_skipped(smoke_bench, capsys):
    smoke_bench.diagnostics(lambda: 1e9)
    ran = capsys.readouterr().err.splitlines()
    timed = [line for line in ran if "pairs/s" in line]
    assert len(timed) == 5, ran
    for label in ("fully cached, one fixed batch", "soft match", "cached target",
                  "projective", "uncached"):
        assert any(line.startswith(label) for line in timed), label
    smoke_bench.diagnostics(lambda: bench.DIAGNOSTIC_MIN_S)
    skipped = capsys.readouterr().err.splitlines()
    assert len(skipped) == 5 and all(line.startswith("diagnostic skipped") for line in skipped)


def launch_counters():
    """The kernel wrappers' launch counters, as (wrapper, attribute) pairs."""
    from delora_tpu_torch.ops.cuda.nn_search import nn_search
    from delora_tpu_torch.ops.cuda.placement import placement
    from delora_tpu_torch.ops.cuda.window_match import (
        window_match,
        window_match_indices,
        window_match_soft,
    )

    return ((placement, "launches_exact"), (placement, "launches_packed"),
            (window_match, "launches"), (window_match_indices, "launches"),
            (window_match_soft, "launches"), (nn_search, "launches"))


def launch_counts():
    return tuple(getattr(fn, name) for fn, name in launch_counters())


def test_cli_bench_on_the_cpu_prints_one_json_line(monkeypatch, capsys):
    from delora_tpu_torch.cli import main

    monkeypatch.setenv("BENCH_SMOKE", "1")
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "1.5")
    monkeypatch.setenv("BENCH_DEADLINE_S", "1")
    monkeypatch.delenv("BENCH_HEADLINE_ONLY", raising=False)
    monkeypatch.setattr(bench, "STEPS_PER_DISPATCH", 1)
    # Other test files in this worker may have counted launches through
    # recorders; the bench's own count starts from 0.
    for fn, name in launch_counters():
        monkeypatch.setattr(fn, name, 0)
    before = launch_counts()
    result = main(["bench", "2", "2", "--device", "cpu"])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == result
    assert tuple(line) == bench.JSON_KEYS
    assert line["metric"] == "scan_pairs_per_sec_per_chip" and line["unit"] == "pairs/s"
    for key in bench.JSON_KEYS:
        if key not in ("metric", "unit", "kernel_parity_max_abs_diff"):
            assert math.isfinite(line[key]), key
    assert line["value"] > 0 and line["vs_baseline"] == round(line["value"] / 10.0, 3)
    assert line["flops_per_step"] > 0 and 0 < line["mfu"] <= 1
    assert line["augment_overflow_tiles"] == 0.0
    assert line["kernel_parity_max_abs_diff"] is None
    assert "kernel parity: null on cpu" in err
    assert "headline warm-up (2 steps)" in err and "5 steps x 2 pairs" in err
    assert sum(x.startswith("diagnostic skipped") for x in err.splitlines()) == 5
    assert launch_counts() == before == (0,) * 6


def test_headline_only_prints_the_short_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_SMOKE", "1")
    monkeypatch.setenv("BENCH_HEADLINE_ONLY", "1")
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(bench, "STEPS_PER_DISPATCH", 1)
    result = bench.main(["2", "1"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result and tuple(line) == ("metric", "value", "unit", "vs_baseline")


def test_bench_without_a_card_refuses_the_cpu():
    from delora_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["2", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["bench", "2", "2"])


def test_peak_is_the_card_s_or_the_override(monkeypatch):
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    with pytest.raises(ValueError, match="BENCH_PEAK_TFLOPS"):
        bench.peak_flops_per_s(torch.device("cpu"))
    with pytest.raises(ValueError, match="BENCH_PEAK_TFLOPS"):
        bench.main(["2", "2"], device="cpu")
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert bench.peak_flops_per_s(cuda) == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Another GPU")
    with pytest.raises(ValueError, match="Another GPU"):
        bench.peak_flops_per_s(cuda)
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "500")
    assert bench.peak_flops_per_s(cuda) == 500e12
