"""The port's SE(3) functions against the jnp ones, atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
