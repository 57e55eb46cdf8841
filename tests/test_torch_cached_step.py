"""The port's cached-target step, the augment branches of the fully-cached and
raw steps, and the raw step at 64x1024 against the JAX package's, in float32
on the CPU.

The batch is ``tests/test_step.py::synthetic_batch`` (16x64, two scan pairs)
and the model the narrow one of ``tests/test_torch_step.py``, whose
``check_step_against_jax`` compares loss, metrics and the gradients of
``jax.value_and_grad`` with its stated tolerances (loss and metrics rtol
1e-5, ``visible_pixels`` within one point; gradients rtol 1e-4 / atol
1e-5 * max|g| per leaf). With augmentation the port's step is given the
rotations the reference's step drew from its ``PRNGKey(0)``, read in the
same compiled program.

The fully-cached augment branch re-projects the rotated survivors, so a point
that lost its pixel before the rotation cannot win one after it, as in the
reference; where projection keeps every source point the branch equals the
cached-target step (``test_fullcached_augment_equals_cached``, loss and
metrics rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 * max|g|: the two steps
compact the same points in the same order, and differ only in the order
the rotated rows enter the matmul).

The raw step at 64x1024 (65,536 pixels, where the reference compacts the
source with ``project_scan_compact``) runs on two random scans of 3,000
points: the shape rule of the port's tests (H <= 32) gives way there,
because no smaller image reaches the threshold.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu.ops.projection_host import scan_artifacts_np as jax_scan_artifacts_np
from delora_tpu.training import step as jstep
from delora_tpu_torch.ops.projection import ProjectionSpec
from delora_tpu_torch.ops.projection_host import scan_artifacts_np
from delora_tpu_torch.training import step as tstep
from delora_tpu_torch.utils.params import grads_to_jax
from tests.test_step import PSPEC, synthetic_batch
from tests.test_torch_step import (
    MODEL,
    assert_trees_close,
    check_step_against_jax,
    fullcached_arrays,
    port_model,
    step_configs,
)

torch.set_num_threads(1)

TSPEC = ProjectionSpec(*PSPEC)


def cached_arrays(batch, artifacts, spec, **kw):
    """The CachedTargetBatch fields as numpy arrays: each target's
    artifacts, the raw source."""
    rows = []
    for b in range(batch.points_1.shape[0]):
        tgt = artifacts(np.asarray(batch.points_1[b]), np.asarray(batch.normals_1[b]),
                        np.asarray(batch.valid_1[b]), spec, **kw)
        rows.append((tgt.image, tgt.normal_image, np.float32(tgt.mean_range)))
    return [np.stack(col) for col in zip(*rows)] + [
        np.array(batch.points_2), np.array(batch.normals_2), np.array(batch.valid_2)]


@pytest.fixture(scope="module")
def scan_pairs():
    return synthetic_batch(seed=3)[0]


@pytest.fixture(scope="module")
def params():
    jmodel = JaxOdometryModel(JaxModelConfig(compute_dtype=jnp.float32, **MODEL))
    x = jnp.zeros((1, PSPEC.height, PSPEC.width, 4), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(0)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.normal(size=s.shape) * 0.5 / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def case_id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items()) or "plain"


CACHED_CASES = [dict(correspondence=c, normalization_scaling=n, augment=a)
                for c in ("image", "projective") for n in (False, True) for a in (False, True)]


@pytest.mark.parametrize("kw", CACHED_CASES, ids=case_id)
def test_cached_step_matches_jax(scan_pairs, params, kw):
    ref = cached_arrays(scan_pairs, jax_scan_artifacts_np, PSPEC, use_native=False)
    port = cached_arrays(scan_pairs, scan_artifacts_np, TSPEC)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(b, a)
    check_step_against_jax(
        jstep.loss_and_metrics_cached, jstep.CachedTargetBatch(*map(jnp.asarray, ref)),
        tstep.loss_and_metrics_cached,
        tstep.CachedTargetBatch(*map(torch.from_numpy, port)), params, kw)


FULLCACHED_CASES = [dict(augment=True), dict(augment=True, normalization_scaling=True),
                    dict(augment=True, correspondence="projective"),
                    dict(correspondence="projective", normalization_scaling=True)]


@pytest.mark.parametrize("kw", FULLCACHED_CASES, ids=case_id)
def test_fullcached_step_matches_jax(scan_pairs, params, kw):
    ref = fullcached_arrays(scan_pairs, jax_scan_artifacts_np, PSPEC, use_native=False)
    port = fullcached_arrays(scan_pairs, scan_artifacts_np, TSPEC)
    check_step_against_jax(
        jstep.loss_and_metrics_fullcached, jstep.FullyCachedBatch(*map(jnp.asarray, ref)),
        tstep.loss_and_metrics_fullcached,
        tstep.FullyCachedBatch(*map(torch.from_numpy, port)), params, kw)


RAW_CASES = [dict(augment=True), dict(augment=True, correspondence="brute"),
             dict(augment=True, correspondence="brute", normalization_scaling=True)]


@pytest.mark.parametrize("kw", RAW_CASES, ids=case_id)
def test_raw_augment_step_matches_jax(scan_pairs, params, kw):
    batch = tstep.ScanPairBatch(*(torch.from_numpy(np.array(x)) for x in scan_pairs))
    check_step_against_jax(jstep.loss_and_metrics, scan_pairs, tstep.loss_and_metrics, batch,
                           params, kw)


@pytest.mark.parametrize("normalization", [False, True])
def test_fullcached_augment_equals_cached(scan_pairs, params, normalization):
    """Where the raw source is exactly its own survivor set, rotating the
    cached survivors is rotating the raw cloud: both steps agree."""
    survivors = fullcached_arrays(scan_pairs, scan_artifacts_np, TSPEC)[4:7]
    batch = scan_pairs._replace(points_2=survivors[0], normals_2=survivors[1],
                                valid_2=survivors[2])
    full = tstep.FullyCachedBatch(*map(torch.from_numpy, fullcached_arrays(
        batch, scan_artifacts_np, TSPEC)))
    cached = tstep.CachedTargetBatch(*map(torch.from_numpy, cached_arrays(
        batch, scan_artifacts_np, TSPEC)))
    assert torch.equal(full.src_points, cached.points_2)
    cfg = tstep.StepConfig(proj=TSPEC, icp=step_configs({})[1].icp, augment=True,
                           normalization_scaling=normalization)
    rotations = tstep.augment_rotations(cfg, 2, torch.Generator().manual_seed(33))
    out = []
    for fn, batch in ((tstep.loss_and_metrics_cached, cached),
                      (tstep.loss_and_metrics_fullcached, full)):
        model = port_model(params)
        loss, metrics = fn(model, batch, cfg, rotations=rotations)
        loss.backward()
        out.append((loss.item(), {k: v.item() for k, v in metrics.items()},
                    grads_to_jax(model)))
    (loss_a, metrics_a, grads_a), (loss_b, metrics_b, grads_b) = out
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-5)
    assert metrics_a["num_po2pl_pairs"] > 5
    for key, value in metrics_a.items():
        np.testing.assert_allclose(metrics_b[key], value, rtol=1e-5, err_msg=key)
    assert_trees_close(grads_a, grads_b, rtol=1e-4, atol_scale=1e-5)


def wide_scans(seed, batch, n):
    """``batch`` scan pairs of ``n`` random points over the sensor's field of
    view, the source a small rigid motion of the target, unit normals (a
    fifth zero)."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-math.pi, math.pi, (batch, n))
    el = rng.uniform(np.deg2rad(-24.0), np.deg2rad(1.5), (batch, n))
    r = rng.uniform(3.0, 40.0, (batch, n))
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1).astype(np.float32)
    nrm = rng.normal(size=(batch, n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[rng.random((batch, n)) < 0.2] = 0.0
    c, s = math.cos(0.01), math.sin(0.01)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    pts2 = (pts @ rot.T + np.array([0.3, 0.05, 0.0], np.float32)).astype(np.float32)
    valid = rng.random((batch, n)) > 0.05
    return jstep.ScanPairBatch(pts, nrm, valid, pts2, (nrm @ rot.T).astype(np.float32), valid)


def test_raw_step_at_64x1024_matches_jax(params):
    spec = PSPEC._replace(height=64, width=1024)
    assert spec.height * spec.width == 1 << 16
    arrays = wide_scans(5, 2, 3000)
    check_step_against_jax(
        jstep.loss_and_metrics, jstep.ScanPairBatch(*map(jnp.asarray, arrays)),
        tstep.loss_and_metrics, tstep.ScanPairBatch(*map(torch.from_numpy, arrays)), params,
        {}, spec)
