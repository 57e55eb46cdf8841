"""The port's SE(3) functions against the jnp ones in float32, atol 1e-6.

The rotation cases include rotations within 1e-4 rad of 180 degrees, exact
180-degree rotations with signed zeros (the quaternion's copysign rule) and
the gimbal-lock pitches of +-90 degrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from delora_tpu import se3 as jse3
from delora_tpu_torch import se3 as tse3


def inputs(seed=0, batch=(5, 3)):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=batch + (4,)).astype(np.float32) * 3.0
    # Unit-scale translations and points: atol 1e-6 is then a few f32 ulps.
    t = rng.normal(size=batch + (3,)).astype(np.float32)
    pts = rng.normal(size=batch + (7, 3)).astype(np.float32)
    return q, t, pts


CASES = {
    "normalize_quat": lambda m, q, t, p: m.normalize_quat(q),
    "quat_to_rotmat": lambda m, q, t, p: m.quat_to_rotmat(q),
    "make_transform": lambda m, q, t, p: m.make_transform(t, m.quat_to_rotmat(q)),
    "transform_from_quat": lambda m, q, t, p: m.transform_from_quat(t, q),
    "transform_points": lambda m, q, t, p: m.transform_points(m.transform_from_quat(t, q), p),
    "rotate_points": lambda m, q, t, p: m.rotate_points(m.transform_from_quat(t, q), p),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se3_matches_jnp(name):
    q, t, p = inputs()
    ref = np.asarray(CASES[name](jse3, jnp.asarray(q), jnp.asarray(t), jnp.asarray(p)))
    out = CASES[name](tse3, torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(p))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_quat_to_rotmat_is_orthonormal():
    q, _, _ = inputs(1)
    R = tse3.quat_to_rotmat(torch.from_numpy(q).double())
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    assert torch.allclose(R @ R.transpose(-1, -2), eye, atol=1e-12)
    assert torch.allclose(torch.linalg.det(R), torch.ones(R.shape[:-2], dtype=torch.float64))


torch.set_num_threads(1)


def rotations(seed=0):
    """[2, 16, 3, 3] float32 rotations: random ones; within 1e-4 rad of
    180 degrees about random axes; exact half turns about x, y and z with
    signed zeros off the diagonal; and yaw-pitch-roll with pitch +-90
    degrees (gimbal lock)."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    near = (np.pi - rng.uniform(0.0, 1e-4, size=(6, 1))) * axes
    half = [np.diag(d) for d in ((1.0, -1.0, -1.0), (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0))]
    signed = []
    for R in half:
        R = R.copy()
        R[R == 0.0] = -0.0
        R[1, 2] = R[0, 2] = R[0, 1] = 0.0       # r21 - r12 etc. are -0.0
        signed.append(R)
    gimbal = Rotation.from_euler("ZYX", [[0.3, np.pi / 2, -0.2], [-1.1, -np.pi / 2, 0.4],
                                         [2.0, np.pi / 2, 2.0]]).as_matrix()
    mats = np.concatenate([Rotation.random(16, random_state=seed).as_matrix(),
                           Rotation.from_rotvec(near).as_matrix(), np.stack(half),
                           np.stack(signed), gimbal, np.eye(3)[None]])
    return mats.reshape(2, 16, 3, 3).astype(np.float32)


def transforms(seed=0):
    R = rotations(seed)
    T = np.zeros(R.shape[:-2] + (4, 4), np.float32)
    T[..., :3, :3] = R
    T[..., :3, 3] = np.random.default_rng(seed + 1).normal(size=R.shape[:-2] + (3,))
    T[..., 3, 3] = 1.0
    return T


ROTATION_CASES = {
    "rotmat_to_quat": lambda m, Ra, Rb, Ta, Tb: m.rotmat_to_quat(Ra),
    "compose": lambda m, Ra, Rb, Ta, Tb: m.compose(Ta, Tb),
    "invert": lambda m, Ra, Rb, Ta, Tb: m.invert(Ta),
    "reorthonormalize": lambda m, Ra, Rb, Ta, Tb: m.reorthonormalize(Ta),
    "matrix_to_euler_zyx": lambda m, Ra, Rb, Ta, Tb: m.matrix_to_euler_zyx(Ra),
    "quat_wxyz_to_xyzw": lambda m, Ra, Rb, Ta, Tb: m.quat_wxyz_to_xyzw(Ta[..., 0, :]),
    "quat_xyzw_to_wxyz": lambda m, Ra, Rb, Ta, Tb: m.quat_xyzw_to_wxyz(Ta[..., 0, :]),
    "rotation_geodesic_angle": lambda m, Ra, Rb, Ta, Tb: m.rotation_geodesic_angle(Ra, Rb),
    "rotation_geodesic_angle_self": lambda m, Ra, Rb, Ta, Tb: m.rotation_geodesic_angle(Ra, Ra),
}


@pytest.mark.parametrize("name", sorted(ROTATION_CASES))
def test_rotation_functions_match_jnp(name):
    Ra, Ta = rotations(0), transforms(0)
    Rb, Tb = rotations(5), transforms(5)
    fn = ROTATION_CASES[name]
    ref = np.asarray(fn(jse3, *(jnp.asarray(x) for x in (Ra, Rb, Ta, Tb))))
    out = fn(tse3, *(torch.from_numpy(x) for x in (Ra, Rb, Ta, Tb)))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_rotmat_to_quat_signs_at_half_turns():
    """Exact half turns: the sign of each vector component follows the sign
    of its antisymmetric difference, +0 or -0, bit for bit with JAX."""
    R = rotations(0).reshape(-1, 3, 3)[22:28]     # half turns, then with -0.0
    ref = np.asarray(jse3.rotmat_to_quat(jnp.asarray(R)))
    out = tse3.rotmat_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_array_equal(np.signbit(out), np.signbit(ref))
    np.testing.assert_array_equal(out, ref)


def test_rotmat_to_quat_round_trip():
    """Away from 180 degrees, within 1e-4: a small component's magnitude is
    the square root of a float32 difference near 0, which loses digits. Near
    a half turn the signs come from an antisymmetric part that rounding
    decides, in both packages."""
    R = torch.from_numpy(rotations(2).reshape(-1, 3, 3)[:16]).double()
    back = tse3.quat_to_rotmat(tse3.rotmat_to_quat(R))
    assert torch.allclose(back, R, rtol=0, atol=1e-4)


def test_rotmat_to_quat_xyzw_np_matches_jax_utils():
    from delora_tpu.utils.poses import rotmat_to_quat_xyzw_np as jax_version
    from delora_tpu_torch.utils.poses import rotmat_to_quat_xyzw_np

    R = rotations(3).reshape(-1, 3, 3).astype(np.float64)
    np.testing.assert_array_equal(rotmat_to_quat_xyzw_np(R), jax_version(R))
