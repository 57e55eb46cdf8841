"""The port's training step and optimizer against the JAX package's, in float32
on the CPU.

The batch is ``tests/test_step.py::synthetic_batch`` (16x64, two scan pairs),
fed raw (``loss_and_metrics``) or turned into fully-cached artifacts by each
package's ``scan_artifacts_np`` (``loss_and_metrics_fullcached``); the model
is the narrow one of the port's model tests with numpy-drawn Flax params. The
cases cover hard and soft matching, the reverse po2pl term with and without
trimming, pair normalization, dropout in eval mode, and on the raw feed the
image matcher and brute correspondence. Tolerances: loss and metrics rtol 1e-5
(``visible_pixels`` within one point); param gradients rtol 1e-4 / atol
1e-5 * max|g| per leaf: the two
frameworks sum a leaf's terms over pixels and batch in different orders, and
where the terms cancel the rounding scales with their sum of magnitudes, not
with the result (measured up to 3.4e-6 * max|g|). The optimizer alone, fed
the same gradients, tracks optax within rtol 1e-6 / atol 1e-6 * max|p|. Over
three whole train steps the params get atol 1e-6 * max|p| + 0.1 * lr per leaf:
where a gradient element cancels to about Adam's eps (1e-8), the update
lr * g / (|g| + eps) turns its last-bit difference between the frameworks
into a visible share of lr (measured: 0.055 lr on one element of the last
stage's first conv, whose taps read mostly the zero rows of the height pad).
The soft matcher's blend is held to the same tolerances: the exp and the
accumulation order of XLA and torch differ in the last bits (the matcher's
own tests bound the blend at rtol 1e-5). Brute correspondence warps the
source by a matmul whose last bits differ between the frameworks; a winner
could then change hands only where two targets lie within that rounding of
each other, and the test checks that no source point of this batch has its
two nearest targets that close (``test_brute_batch_has_no_near_ties``). The
parameter EMA fed the same gradients as optax's ``track_param_ema`` tracks it
within rtol 1e-6 / atol 1e-6 * max|p|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.losses.icp import IcpLossConfig as JaxIcpLossConfig
from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu.ops.projection_host import scan_artifacts_np as jax_scan_artifacts_np
from delora_tpu.training import step as jstep
from delora_tpu.training.state import TrainState, deploy_state
from delora_tpu.training.state import make_optimizer as jax_make_optimizer
from delora_tpu_torch.losses.icp import IcpLossConfig
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.ops.projection import ProjectionSpec
from delora_tpu_torch.ops.projection_host import scan_artifacts_np
from delora_tpu_torch.training import step as tstep
from delora_tpu_torch.training.state import (
    deploy_model,
    ema_params,
    make_optimizer,
    make_param_ema,
)
from delora_tpu_torch.utils.params import grads_to_jax, params_from_jax, params_to_jax
from tests.test_step import PSPEC, synthetic_batch

TSPEC = ProjectionSpec(*PSPEC)
MODEL = dict(resnet_outputs=16, blocks_per_stage=(1, 1, 1, 1), channel_divisor=16)
METRICS = ("loss", "loss_pc", "loss_po2po", "loss_po2pl", "loss_pl2pl", "loss_po2pl_rev",
           "loss_identity", "num_po2pl_pairs", "visible_pixels", "placement_overflow_tiles")


def fullcached_arrays(batch, artifacts, spec, **kw):
    """The FullyCachedBatch fields as numpy arrays, scan by scan."""
    rows = []
    for b in range(batch.points_1.shape[0]):
        tgt = artifacts(np.asarray(batch.points_1[b]), np.asarray(batch.normals_1[b]),
                        np.asarray(batch.valid_1[b]), spec, **kw)
        src = artifacts(np.asarray(batch.points_2[b]), np.asarray(batch.normals_2[b]),
                        np.asarray(batch.valid_2[b]), spec, **kw)
        rows.append((tgt.image, tgt.normal_image, np.float32(tgt.mean_range), src.image,
                     src.src_points, src.src_normals, src.src_valid,
                     np.float32(src.mean_range)))
    return [np.stack(col) for col in zip(*rows)]


@pytest.fixture(scope="module")
def scan_pairs():
    return synthetic_batch(seed=3)[0]


@pytest.fixture(scope="module")
def data(scan_pairs):
    batch = scan_pairs
    ref = fullcached_arrays(batch, jax_scan_artifacts_np, PSPEC, use_native=False)
    port = fullcached_arrays(batch, scan_artifacts_np, TSPEC)
    jmodel = JaxOdometryModel(JaxModelConfig(compute_dtype=jnp.float32, **MODEL))
    x = jnp.zeros((1, PSPEC.height, PSPEC.width, 4), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(0)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.normal(size=s.shape) * 0.5 / np.sqrt(fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map(draw, shapes)
    return ref, port, jmodel, params


def port_model(params, **kw):
    model = OdometryModel(ModelConfig(compute_dtype=torch.float32, **MODEL, **kw))
    model.load_state_dict(params_from_jax(params))
    return model


def assert_metrics_close(ref, out):
    for key in METRICS:
        a, b = float(ref[key]), float(out[key])
        if key == "visible_pixels":
            assert abs(a - b) <= 1.0, (key, a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=key)


def assert_trees_close(ref, out, rtol, atol_scale, atol_extra=0.0):
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(out)[0])
    assert len(flat_ref) == len(flat_out)
    for path, a in flat_ref:
        a = np.asarray(a)
        np.testing.assert_allclose(flat_out[path], a, rtol=rtol,
                                   atol=atol_scale * np.abs(a).max() + atol_extra,
                                   err_msg=jax.tree_util.keystr(path))


def test_artifacts_feed_both_packages_equal(data):
    ref, port, _, _ = data
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b, a)


CASES = {
    "unsupervised": dict(),
    "unsupervised-normalized": dict(normalization_scaling=True),
    "supervised": dict(supervised=True),
    "unsupervised-trim": dict(trim=0.5),
    "soft": dict(soft_match_sigma=0.3),
    "soft-reverse": dict(soft_match_sigma=0.3, lambda_rev_po2pl=1.0),
    "reverse-trim": dict(lambda_rev_po2pl=1.0, trim=0.5),
    "soft-reverse-normalized": dict(soft_match_sigma=0.3, lambda_rev_po2pl=1.0,
                                    normalization_scaling=True),
    "dropout-eval": dict(use_dropout=True, deterministic=True),
}
RAW_CASES = {
    "raw-image": dict(correspondence="image"),
    "raw-brute": dict(correspondence="brute"),
    "raw-brute-normalized": dict(correspondence="brute", normalization_scaling=True),
}


def step_configs(kw):
    """(JAX StepConfig, port StepConfig, model keywords) of a case."""
    kw = dict(kw)
    trim = kw.pop("trim", 0.0)
    model_kw = {k: kw.pop(k) for k in ("use_dropout",) if k in kw}
    kw.setdefault("correspondence", "image")
    jcfg = jstep.StepConfig(proj=PSPEC, icp=JaxIcpLossConfig(trim_sq_distance=trim * trim),
                            **kw)
    cfg = tstep.StepConfig(proj=TSPEC, icp=IcpLossConfig(trim_sq_distance=trim * trim), **kw)
    return jcfg, cfg, model_kw


def check_step_against_jax(jax_loss_fn, jbatch, port_loss_fn, batch, params, kw):
    """Loss, metrics and gradients of one step of each package on the same
    params and batch."""
    jcfg, cfg, model_kw = step_configs(kw)
    jmodel = JaxOdometryModel(JaxModelConfig(compute_dtype=jnp.float32, **MODEL, **model_kw))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jmodel.apply, p, jbatch, jcfg, jax.random.PRNGKey(0)),
        has_aux=True))
    (loss_ref, (metrics_ref, _)), grads_ref = grad_fn(params)

    model = port_model(params, **model_kw)
    loss, metrics = port_loss_fn(model, batch, cfg)
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    assert_metrics_close(metrics_ref, {k: v.detach() for k, v in metrics.items()})
    assert float(metrics_ref["num_po2pl_pairs"]) > 5
    assert_trees_close(grads_ref, grads_to_jax(model), rtol=1e-4, atol_scale=1e-5)
    grad_norm = tstep.optax_global_norm([p.grad for p in model.parameters()])
    np.testing.assert_allclose(grad_norm.item(), float(jstep.optax_global_norm(grads_ref)),
                               rtol=1e-4)
    return metrics


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_metrics_and_grads_match_jax(data, case):
    ref_arrays, port_arrays, _, params = data
    metrics = check_step_against_jax(
        jstep.loss_and_metrics_fullcached, jstep.FullyCachedBatch(*map(jnp.asarray, ref_arrays)),
        tstep.loss_and_metrics_fullcached,
        tstep.FullyCachedBatch(*map(torch.from_numpy, port_arrays)), params, CASES[case])
    if CASES[case].get("lambda_rev_po2pl"):
        assert metrics["loss_po2pl_rev"].item() > 0.0


def port_scan_pairs(batch):
    return tstep.ScanPairBatch(*(torch.from_numpy(np.array(x)) for x in batch))


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_raw_loss_metrics_and_grads_match_jax(data, scan_pairs, case):
    params = data[3]
    check_step_against_jax(jstep.loss_and_metrics, scan_pairs, tstep.loss_and_metrics,
                           port_scan_pairs(scan_pairs), params, RAW_CASES[case])


def test_raw_feed_beyond_65536_pixels_raises():
    """The reference compacts the source with ``project_scan_compact`` there,
    which is not ported: the step refuses before it runs the model."""
    spec = ProjectionSpec(64, 1024, *TSPEC[2:])
    cfg = tstep.StepConfig(proj=spec, icp=IcpLossConfig(), correspondence="brute")
    pts = torch.ones(1, 64, 3)
    batch = tstep.ScanPairBatch(pts, pts, torch.ones(1, 64, dtype=torch.bool), pts, pts,
                                torch.ones(1, 64, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="project_scan_compact"):
        tstep.loss_and_metrics(None, batch, cfg)


def test_brute_batch_has_no_near_ties(scan_pairs):
    """Under the identity pose (the narrow model's outputs stay near it), no
    source survivor of the raw batch has its two nearest target survivors
    within a relative 1e-5 of each other, so the frameworks' last-bit
    differences in the warp cannot move a brute winner."""
    from scipy.spatial import cKDTree

    from delora_tpu_torch.ops.projection import project_compact_exact_batch, project_scan_batch

    batch = port_scan_pairs(scan_pairs)
    target = project_scan_batch(batch.points_1, batch.valid_1, TSPEC)
    source = project_compact_exact_batch(batch.points_2, batch.valid_2, TSPEC)
    for b in range(batch.points_1.shape[0]):
        tgt = batch.points_1[b][target.survivor[b]].double().numpy()
        src = source.comp_vals[b][source.comp_mask[b], 0:3].double().numpy()
        dist, _ = cKDTree(tgt).query(src, k=2)
        gap = (dist[:, 1] ** 2 - dist[:, 0] ** 2) / np.maximum(dist[:, 1] ** 2, 1e-12)
        assert len(src) > 100 and gap.min() > 1e-5, gap.min()


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_three_adam_steps_track_optax(data, schedule):
    ref_arrays, port_arrays, jmodel, params = data
    config = {"learning_rate": 1e-4, "lr_scaling": "none", "lr_schedule": schedule,
              "lr_decay_steps": 2, "lr_min_ratio": 0.1}
    B = ref_arrays[0].shape[0]
    state = TrainState.create(apply_fn=jmodel.apply, params=params,
                              tx=jax_make_optimizer(config, B))
    jcfg = jstep.StepConfig(proj=PSPEC, icp=JaxIcpLossConfig(), correspondence="image")
    jax_step = jstep.make_train_step_fullcached(jmodel, jcfg, donate=False)
    jbatch = jstep.FullyCachedBatch(*map(jnp.asarray, ref_arrays))

    model = port_model(params)
    optimizer, lr_schedule = make_optimizer(config, model.parameters(), B)
    cfg = tstep.StepConfig(proj=TSPEC, icp=IcpLossConfig())
    batch = tstep.FullyCachedBatch(*map(torch.from_numpy, port_arrays))
    for _ in range(3):
        state, metrics_ref = jax_step(state, jbatch, jax.random.PRNGKey(0))
        metrics = tstep.train_step(model, optimizer, batch, cfg, lr_schedule)
        assert_metrics_close(metrics_ref, metrics)
        np.testing.assert_allclose(metrics["grad_norm"].item(),
                                   float(metrics_ref["grad_norm"]), rtol=1e-4)
        assert_trees_close(state.params, params_to_jax(model.state_dict()), rtol=1e-6,
                           atol_scale=1e-6, atol_extra=0.1 * config["learning_rate"])


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adam_on_the_same_gradients_tracks_optax(schedule):
    config = {"learning_rate": 1e-3, "lr_scaling": "none", "lr_schedule": schedule,
              "lr_decay_steps": 2, "lr_min_ratio": 0.1}
    rng = np.random.default_rng(1)
    shapes = {"w": (4, 3), "b": (3,), "v": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = jax_make_optimizer(config, 8)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    optimizer, lr_schedule = make_optimizer(config, list(tparams.values()), 8)
    import optax

    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
        lr_schedule.step()
        assert_trees_close(jparams, {k: p.detach().numpy() for k, p in tparams.items()},
                           rtol=1e-6, atol_scale=1e-6)


def test_cosine_schedule_counts_updates_before_the_step():
    """optax evaluates the schedule at the update count before the step: the
    rates of steps 0, 1, 2, 3 with 2 decay steps are lr * (1, 0.55, 0.1, 0.1)."""
    model = torch.nn.Linear(2, 1)
    config = {"learning_rate": 1e-3, "lr_schedule": "cosine", "lr_decay_steps": 2,
              "lr_min_ratio": 0.1}
    optimizer, schedule = make_optimizer(config, model.parameters(), 8)
    rates = []
    for _ in range(4):
        rates.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        schedule.step()
    np.testing.assert_allclose(rates, [1e-3, 0.55e-3, 1e-4, 1e-4], rtol=1e-12)


def test_linear_lr_scaling():
    from delora_tpu_torch.training.state import effective_learning_rate

    config = {"learning_rate": 1e-4, "lr_scaling": "linear", "lr_scaling_base_batch": 32}
    assert effective_learning_rate(config, 64) == pytest.approx(2e-4)
    assert effective_learning_rate({"learning_rate": 1e-4}, 64) == 1e-4


@pytest.mark.parametrize("key", ["fused_adam"])
def test_unported_optimizer_settings_raise(key):
    config = {"learning_rate": 1e-4, key: True}
    with pytest.raises(NotImplementedError):
        make_optimizer(config, torch.nn.Linear(2, 1).parameters(), 8)


def test_ema_is_off_by_default_and_allocates_nothing():
    model = torch.nn.Linear(2, 1)
    assert make_param_ema({"ema_decay": 0.0}, model) is None
    assert ema_params(None) is None and deploy_model(model, None) is model


@pytest.mark.parametrize("decay", [0.999, 0.9])
def test_adam_with_ema_tracks_optax(data, decay):
    """K Adam steps with the parameter EMA, fed the same gradients, against
    ``optax.chain(optax.adam, track_param_ema)``; the deploy model carries
    the EMA as ``deploy_state`` does."""
    params = data[3]
    config = {"learning_rate": 1e-3, "lr_scaling": "none", "ema_decay": decay}
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 0.1).astype(np.float32), params)
        for _ in range(3)]
    state = TrainState.create(apply_fn=None, params=params, tx=jax_make_optimizer(config, 8))
    model = port_model(params)
    optimizer, schedule = make_optimizer(config, model.parameters(), 8)
    ema = make_param_ema(config, model)
    named = dict(model.named_parameters())
    assert all(e.data_ptr() != named[k].data_ptr() for k, e in ema_params(ema).items())
    for g in grads:
        state = state.apply_gradients(grads=jax.tree_util.tree_map(jnp.asarray, g))
        for k, v in params_from_jax(g).items():
            named[k].grad = v
        optimizer.step()
        schedule.step()
        ema.update(model)
    assert_trees_close(state.params, params_to_jax(model.state_dict()), rtol=1e-6,
                       atol_scale=1e-6)
    deployed = deploy_model(model, ema)
    assert deployed is not model and not deployed.training
    assert_trees_close(deploy_state(state).params, params_to_jax(deployed.state_dict()),
                       rtol=1e-6, atol_scale=1e-6)
    assert not torch.equal(deployed.resnet.fc.weight, model.resnet.fc.weight)
