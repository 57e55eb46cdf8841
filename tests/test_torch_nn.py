"""The port's exact 1-NN search and brute correspondence against the JAX
package's, on the CPU.

The plain search (what the CPU path runs, and what the CUDA kernel is held
against on the card) forms the distances with the fmas of the reference's
kernel, so its indices and squared distances are bit-equal to
``nn_search_pallas`` in interpret mode, single and batched, and its winners
equal those of the XLA route of ``brute_force_correspondence``. Against
``scipy.spatial.cKDTree`` (float64, exact) the winner is the same wherever the
runner-up's squared distance is more than a relative 1e-5 away, and the
float32 squared distance is within 1e-6 * (|s|^2 + |t|^2) of the exact one
(the formula cancels: its rounding scales with the squared norms, not with the
distance). The inputs hold duplicated targets (exact ties: the lower index
wins), ragged sizes, and batches without a valid target.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import delora_tpu.ops.pallas.nn_search as jnn
from delora_tpu.ops import correspondence as jcorr
from delora_tpu_torch.ops import correspondence as tcorr
from delora_tpu_torch.ops.cuda.nn_search import nn_search, nn_search_plain
from delora_tpu_torch.ops.cuda.window_match import fma_exact


def cloud(seed, batch, n_src, n_tgt, valid_share=0.5):
    """Sources and targets at a 20 m scale; every fifth target repeats its
    left neighbour (ties); the last batch has no valid target when batch > 1."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(batch, n_src, 3)) * 20).astype(np.float32)
    tgt = (rng.normal(size=(batch, n_tgt, 3)) * 20).astype(np.float32)
    tgt[:, 1::5] = tgt[:, 0::5][:, : tgt[:, 1::5].shape[1]]
    # Sources exactly on duplicated targets, so that the tie is the winner.
    src[:, :10] = tgt[:, 1:51:5][:, :10]
    valid = rng.random((batch, n_tgt)) < valid_share
    valid[:, 0:50] = True
    if batch > 1:
        valid[-1] = False
    return src, tgt, valid


def plain(src, tgt, valid):
    idx, sq = nn_search_plain(*map(torch.from_numpy, (src, tgt, valid)))
    return idx.numpy(), sq.numpy()


@pytest.mark.parametrize("n_src,n_tgt", [(700, 900), (333, 1777), (2048, 2048)])
def test_plain_bit_equal_to_pallas_single(n_src, n_tgt):
    src, tgt, valid = cloud(n_src, 1, n_src, n_tgt)
    idx, sq = plain(src, tgt, valid)
    ref_idx, ref_sq = jnn.nn_search_pallas(*map(jnp.asarray, (src[0], tgt[0], valid[0])),
                                           tile_s=128, tile_t=256, interpret=True)
    np.testing.assert_array_equal(idx[0], np.asarray(ref_idx))
    np.testing.assert_array_equal(sq[0], np.asarray(ref_sq))
    # Ties: each of the first ten sources sits on a duplicated pair; the lower
    # index wins.
    np.testing.assert_array_equal(idx[0, :10], np.arange(0, 50, 5))


def test_plain_bit_equal_to_pallas_batched_with_an_empty_batch():
    src, tgt, valid = cloud(5, 3, 500, 1200)
    idx, sq = plain(src, tgt, valid)
    fn = jax.vmap(lambda s, t, v: jnn.nn_search_pallas(s, t, v, tile_s=128, tile_t=256,
                                                        interpret=True))
    ref_idx, ref_sq = fn(*map(jnp.asarray, (src, tgt, valid)))
    np.testing.assert_array_equal(idx, np.asarray(ref_idx))
    np.testing.assert_array_equal(sq, np.asarray(ref_sq))
    assert (sq[-1] == np.float32(1e30)).all() and (idx[-1] == 0).all()


def test_no_valid_target():
    src, tgt, valid = cloud(6, 1, 130, 200)
    idx, sq = plain(src, tgt, np.zeros_like(valid))
    assert (sq >= 1e29).all() and (idx == 0).all()


@pytest.mark.parametrize("seed", [7, 8])
def test_plain_matches_kdtree(seed):
    src, tgt, valid = cloud(seed, 1, 1500, 2000)
    idx, sq = plain(src, tgt, valid)
    s, t = src[0].astype(np.float64), tgt[0][valid[0]].astype(np.float64)
    dist, kidx = cKDTree(t).query(s, k=2)
    remap = np.nonzero(valid[0])[0]
    exact = dist[:, 0] ** 2
    gap = (dist[:, 1] ** 2 - exact) / np.maximum(dist[:, 1] ** 2, 1e-30)
    clear = gap > 1e-5
    tie = gap == 0                          # a duplicated target
    assert (clear | tie).mean() > 0.99 and tie.any()
    np.testing.assert_array_equal(idx[0][clear], remap[kidx[clear, 0]])
    won = np.linalg.norm(tgt[0][idx[0]].astype(np.float64) - s, axis=-1)
    np.testing.assert_array_equal(won[tie], dist[tie, 0])
    scale = (s * s).sum(-1) + (tgt[0][idx[0]].astype(np.float64) ** 2).sum(-1)
    assert (np.abs(sq[0] - exact) <= 1e-6 * scale).all()
    assert valid[0][idx[0]].all()


def test_exact_fma_rounds_once():
    """fma_exact against float64 where the float64 sum is exact, and where
    rounding the float64 sum to float32 would round twice."""
    rng = np.random.default_rng(0)
    a = rng.integers(-2**11, 2**11, 1000).astype(np.float32)
    b = (rng.integers(-2**11, 2**11, 1000) / 2).astype(np.float32)
    c = rng.integers(-2**20, 2**20, 1000).astype(np.float32)
    out = fma_exact(*map(torch.from_numpy, (a, b, c))).numpy()
    np.testing.assert_array_equal(out, (a.astype(np.float64) * b + c).astype(np.float32))
    # (1 + 2**-23)(1 - 2**-23) + 2**24 + 2 = 2**24 + 3 - 2**-46: just below the
    # midpoint of the floats 2**24 + 2 and 2**24 + 4, so it rounds down; the
    # float64 sum drops the 2**-46, lands on the midpoint and ties to even, up.
    a, b, c = (torch.tensor([v], dtype=torch.float32)
               for v in (1 + 2**-23, 1 - 2**-23, 2**24 + 2))
    assert (a.double() * b.double() + c.double()).float().item() == 2**24 + 4
    assert fma_exact(a, b, c).item() == 2**24 + 2


@pytest.mark.parametrize("use_pallas", [False, True])
def test_brute_correspondence_matches_jax(monkeypatch, use_pallas):
    """``brute_force_correspondence`` against the reference's on both of its
    routes (the Pallas kernel in interpret mode): winners, normals and
    validity bit-equal, the recomputed squared distance within rtol 1e-6
    (XLA forms that sum of squares with fmas), and its gradient."""
    monkeypatch.setattr(jnn, "nn_search_pallas",
                        functools.partial(jnn.nn_search_pallas, interpret=True))
    src, tgt, valid = cloud(9, 2, 600, 1000)
    rng = np.random.default_rng(10)
    nrm = rng.normal(size=tgt.shape).astype(np.float32)
    src_valid = rng.random(src.shape[:2]) < 0.9
    ref = jax.vmap(lambda s, m, t, tv, tn: jcorr.brute_force_correspondence(
        s, m, t, tv, tn, use_pallas=use_pallas))(*map(jnp.asarray, (src, src_valid, tgt, valid,
                                                                   nrm)))
    src_t = torch.from_numpy(src).requires_grad_(True)
    out = tcorr.brute_force_correspondence(src_t, *map(torch.from_numpy, (src_valid, tgt, valid,
                                                                          nrm)))
    for name in ("target_points", "target_normals", "valid"):
        np.testing.assert_array_equal(getattr(out, name).detach().numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.sq_dist.detach().numpy(), np.asarray(ref.sq_dist), rtol=1e-6)
    assert not out.valid[-1].any() and out.valid[0].float().mean() > 0.8
    torch.where(out.valid, out.sq_dist, 0.0).sum().backward()
    expected = 2 * (src - out.target_points.numpy()) * out.valid.numpy()[..., None]
    np.testing.assert_allclose(src_t.grad.numpy(), expected, rtol=1e-6, atol=1e-5)


def test_nn_search_rejects_bad_inputs():
    x = torch.zeros(1, 4, 3)
    m = torch.ones(1, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        nn_search(x.double(), x.double(), m)
    with pytest.raises(ValueError):
        nn_search(x, x, m.float())
    with pytest.raises(ValueError):
        nn_search(x, x[:, :0], m[:, :0])
    with pytest.raises(ValueError):
        nn_search(x.to("meta"), x.to("meta"), m.to("meta"))
