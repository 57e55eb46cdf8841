"""The port's augmentation (``se3.axis_angle_to_rotmat``,
``training/step.py::augment_rotations`` and ``_augment``) against the JAX
package's, on the CPU.

``axis_angle_to_rotmat`` is held against the jitted reference within atol
1e-7 (the two frameworks' sin and cos may differ in the last bit; rotation
entries are at most 1), and exactly at angle 0 and below eps, where both
return the identity. ``_augment`` at one rotation is bit-equal to the
reference's: the rotation is the one JAX draws for a key, read off by
rotating identity rows in the same compiled program
(``reference_rotations``). A separately compiled draw need not be the same
rotation: XLA may compile its sin, cos and products another way there, and
the entries then differ in their last bits.
The port's own draw cannot match
``jax.random``, so it is held to the reference's distribution by its
statistics: axes in the positive octant (or z for yaw only), angles within
+-magnitude/2 and spread evenly (each of 10 bins within 15% of its expected
count of 20,000 draws, a 5-sigma band), and the same rotations from the same
seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu import se3 as jse3
from delora_tpu.losses.icp import IcpLossConfig as JaxIcpLossConfig
from delora_tpu.training import step as jstep
from delora_tpu_torch import se3
from delora_tpu_torch.losses.icp import IcpLossConfig
from delora_tpu_torch.training import step as tstep
from tests.test_step import PSPEC

torch.set_num_threads(1)

MAGNITUDE = 4.0 / 180.0 * math.pi


def reference_rotations(key, batch_size, cfg):
    """The [B, 3, 3] rotations R that the reference's ``_augment`` applies
    with ``key`` (points times R^T): ``_augment`` of identity rows is R^T.
    Trace it in the program whose rotation it should read (the reference's
    loss functions pass ``jax.random.split(rng)[0]``)."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (batch_size, 3, 3))
    rt, _ = jstep._augment(eye, eye, key, cfg)
    return jnp.swapaxes(rt, -1, -2)


def test_axis_angle_to_rotmat_matches_jax():
    rng = np.random.default_rng(0)
    aa = np.concatenate([
        rng.normal(size=(64, 3)) * 0.5,                        # general angles
        rng.normal(size=(8, 3)) * 1e-3,                        # small angles
        np.zeros((1, 3)),                                      # angle 0
        np.full((1, 3), 1e-13),                                # below eps
        np.array([[math.pi, 0.0, 0.0], [0.0, 0.0, -MAGNITUDE / 2]]),
    ]).astype(np.float32)
    ref = np.asarray(jax.jit(jse3.axis_angle_to_rotmat)(aa))
    out = se3.axis_angle_to_rotmat(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)
    for i in (72, 73):
        assert np.array_equal(out[i], np.eye(3, dtype=np.float32))
        assert np.array_equal(ref[i], np.eye(3, dtype=np.float32))


@pytest.mark.parametrize("only_yaw", [False, True], ids=["axis", "yaw"])
def test_augment_at_the_reference_rotation_is_bit_equal(only_yaw):
    rng = np.random.default_rng(1)
    points = (rng.normal(size=(3, 2000, 3)) * 20.0).astype(np.float32)
    normals = rng.normal(size=(3, 2000, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    cfg = jstep.StepConfig(proj=PSPEC, icp=JaxIcpLossConfig(), augment=True,
                           augment_only_yaw=only_yaw, augment_magnitude_rad=MAGNITUDE)
    (ref_p, ref_n), R = jax.jit(lambda p, n: (jstep._augment(p, n, key, cfg),
                                              reference_rotations(key, 3, cfg)))(points, normals)
    R = np.array(R)
    # A rotation within +-2 degrees, not the identity.
    angles = np.degrees(np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert (angles > 0).all() and (angles <= 2.0 + 1e-4).all()
    out_p, out_n = tstep._augment(torch.from_numpy(points), torch.from_numpy(normals),
                                  torch.from_numpy(R))
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(out_n.numpy(), np.asarray(ref_n))


def test_augment_needs_rotations():
    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="rotations"):
        tstep._augment(x, x, None)


def rotation_axis_angle(R):
    """Signed angle and unit axis of rotations [n, 3, 3], the axis taken in
    the closed positive half-space of (1, 1, 1)."""
    angle = np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0))
    skew = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                     R[:, 1, 0] - R[:, 0, 1]], -1)
    axis = skew / np.linalg.norm(skew, axis=-1, keepdims=True)
    sign = np.where(axis.sum(-1) < 0, -1.0, 1.0)
    return angle * sign, axis * sign[:, None]


@pytest.mark.parametrize("only_yaw", [False, True], ids=["axis", "yaw"])
def test_draw_follows_the_reference_distribution(only_yaw):
    n = 20000
    cfg = tstep.StepConfig(proj=tstep.ProjectionSpec(*PSPEC), icp=IcpLossConfig(),
                           augment=True, augment_only_yaw=only_yaw,
                           augment_magnitude_rad=MAGNITUDE)
    R = tstep.augment_rotations(cfg, n, torch.Generator().manual_seed(3)).double().numpy()
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-6)
    angle, axis = rotation_axis_angle(R)
    keep = np.abs(angle) > 1e-3           # the axis of a tiny rotation is rounding noise
    if only_yaw:
        np.testing.assert_allclose(axis[keep], np.broadcast_to([0.0, 0.0, 1.0], axis[keep].shape),
                                   atol=1e-4)
    else:
        # Every axis lies in the positive octant (up to the sign the angle
        # carries), and the octant is filled: no axis sits on a face only.
        assert (axis[keep] >= -1e-4).all()
        assert (axis[keep].min(-1) > 0.3).any() and (axis[keep].max(-1) > 0.95).any()
    assert np.abs(angle).max() <= MAGNITUDE / 2 + 1e-6
    counts, _ = np.histogram(angle, bins=10, range=(-MAGNITUDE / 2, MAGNITUDE / 2))
    assert (np.abs(counts - n / 10) <= 0.15 * n / 10).all(), counts


def test_draw_is_reproducible_from_a_seed():
    cfg = tstep.StepConfig(proj=tstep.ProjectionSpec(*PSPEC), icp=IcpLossConfig(),
                           augment=True)
    a = tstep.augment_rotations(cfg, 8, torch.Generator().manual_seed(11))
    b = tstep.augment_rotations(cfg, 8, torch.Generator().manual_seed(11))
    c = tstep.augment_rotations(cfg, 8, torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(11)
    first = tstep.augment_rotations(cfg, 8, g)
    assert not torch.equal(first, tstep.augment_rotations(cfg, 8, g))


def test_step_config_reads_the_reference_keys():
    from delora_tpu.config import load_config
    from delora_tpu_torch.config import default_config

    over = {"random_point_cloud_rotations": True, "random_rotations_only_yaw": True,
            "magnitude_random_rot": 6.0}
    cfg = tstep.StepConfig.from_config(default_config(over), supervised=False)
    ref = jstep.StepConfig.from_config(load_config(over), "kitti", supervised=False)
    assert (cfg.augment, cfg.augment_only_yaw) == (ref.augment, ref.augment_only_yaw) == (
        True, True)
    assert cfg.augment_magnitude_rad == ref.augment_magnitude_rad == 6.0 / 180.0 * math.pi
