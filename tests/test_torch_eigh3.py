"""The port's closed-form 3x3 eigensolver (``delora_tpu_torch/ops/eigh3.py``)
against the JAX package's (``delora_tpu/ops/eigh3.py``), jitted, on the same
float32 matrices.

Tolerances: eigenvalues within 1e-5 of the largest magnitude (float32
rounding of a trigonometric solve whose transcendentals differ from XLA's in
the last bit); eigenvectors within 4e-6 * kappa, kappa = |lambda|_max /
(lambda_2 - lambda_1), about 32 float32 ulps times the eigenvector's
first-order sensitivity to a relative error of the matrix (the two solvers'
difference measured at most 1.2e-6 * kappa); unit length, or zero in the same
places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.ops import eigh3 as jeigh
from delora_tpu_torch.ops import eigh3 as teigh

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)

_jit_vec = jax.jit(jeigh.smallest_eigenvector_sym3x3)
_jit_vals = jax.jit(jeigh.eigenvalues_sym3x3)


def random_spd(n, seed):
    A = np.random.default_rng(seed).normal(size=(n, 3, 3))
    return (A @ A.transpose(0, 2, 1)).astype(np.float32)


def planar(n, seed):
    """Covariances of noisy planar patches: one small eigenvalue."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    evals = np.stack([rng.uniform(1e-4, 1e-2, n), rng.uniform(0.5, 2.0, n),
                      rng.uniform(2.0, 9.0, n)], -1)
    return np.einsum("nij,nj,nkj->nik", basis, evals, basis).astype(np.float32)


MATRICES = {"spd": random_spd(2048, 0), "planar": planar(2048, 1)}


def conditioning(A):
    w = np.linalg.eigvalsh(A.astype(np.float64))
    return np.abs(w).max(-1) / np.maximum(w[:, 1] - w[:, 0], 1e-30)


@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_eigenvalues_match_jax(kind):
    A = MATRICES[kind]
    ref = np.asarray(_jit_vals(jnp.asarray(A)))
    out = teigh.eigenvalues_sym3x3(torch.from_numpy(A)).numpy()
    scale = np.abs(ref).max(-1, keepdims=True)
    assert np.abs(out - ref).max() <= 1e-5 * scale.max()
    assert (np.abs(out - ref) <= 1e-5 * scale).all()
    assert (np.diff(out, axis=-1) >= 0).all()


@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_smallest_eigenvector_matches_jax(kind):
    A = MATRICES[kind]
    v_ref, _ = (np.asarray(x) for x in _jit_vec(jnp.asarray(A)))
    v, _ = teigh.smallest_eigenvector_sym3x3(torch.from_numpy(A))
    v = v.numpy()
    tol = 4e-6 * conditioning(A)
    assert (np.abs(v - v_ref).max(-1) <= tol).all()
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)


def test_isotropic_gives_the_zero_vector_as_jax():
    A = np.stack([np.eye(3, dtype=np.float32) * s for s in (0.0, 1.0, 7.5)])
    v_ref, _ = _jit_vec(jnp.asarray(A))
    v, _ = teigh.smallest_eigenvector_sym3x3(torch.from_numpy(A))
    assert (v.numpy() == 0.0).all() and (np.asarray(v_ref) == 0.0).all()


def test_equal_cross_products_take_the_first_as_jax():
    """diag(0, 1, 1): lambda = 0, the three cross products of A's rows are
    (0, 0, 0), (0, 0, 0) and (1, 0, 0); diag(1, 1, 0) and permuted
    duplicates give equal norms, where both solvers take the first."""
    A = np.stack([np.diag([0.0, 1.0, 1.0]), np.diag([1.0, 1.0, 0.0]),
                  np.diag([1.0, 0.0, 1.0]), np.diag([2.0, 2.0, 1.0])]).astype(np.float32)
    v_ref, _ = _jit_vec(jnp.asarray(A))
    v, _ = teigh.smallest_eigenvector_sym3x3(torch.from_numpy(A))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))


def test_check_planarity_matches_jax():
    evals = np.asarray([[0.001, 1.0, 1.0], [0.5, 0.6, 0.7], [0.0005, 0.001, 1.0],
                        [0.0, 0.0, 0.0]], np.float32)
    ref = np.asarray(jeigh.check_planarity(jnp.asarray(evals), 0.01, 0.01))
    out = teigh.check_planarity(torch.from_numpy(evals), 0.01, 0.01).numpy()
    np.testing.assert_array_equal(out, ref)
