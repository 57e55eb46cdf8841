"""The port's window matchers (hard, soft, index-only) against the JAX
package's, on the CPU.

The plain matcher (what the CPU path runs, and what the CUDA kernel is held
against on the card) must give bit-equal winners to the reference's jitted
XLA loop and to its Pallas kernel in interpret mode: squared distance, target
xyz and target normal. The inputs have empty rows, empty windows (no
candidate: +inf) and duplicated target points, so that exact ties occur and
the first offset must win. ``image_space_correspondence_batch`` must give the
reference's ``Correspondence``: points, normals and validity bit-equal, and
the recomputed ``sq_dist`` within rtol 1e-6 (XLA fuses that sum of squares
with FMAs in an order that depends on its vectorization).

The soft matcher's plain version is held to the XLA core and to the Pallas
kernel in interpret mode: squared distances and misses (which windows
underflow) bit-equal, blends within rtol 1e-5 / atol 1e-6 (XLA's exp and its
contraction of ``acc + w * cand`` into FMAs differ from torch's separate
operations in the last bits; measured up to 3.4e-7 relative). The index-only
search (``window_match_indices``) is bit-equal to JAX's: offsets, squared
distances, validity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.ops import correspondence as jcorr
from delora_tpu.ops import projection as jproj
from delora_tpu.ops.pallas.window_match import window_match_pallas
from delora_tpu_torch.ops import correspondence as tcorr
from delora_tpu_torch.ops.cuda.window_match import (
    window_match,
    window_match_indices_plain,
    window_match_plain,
    window_match_soft,
    window_match_soft_plain,
)
from delora_tpu_torch.ops.projection import ProjectionSpec

H, B = 16, 2
FOV = dict(fov_up=0.035, fov_down=-0.43, fov_left=-3.14, fov_right=3.14)
CASES = [(64, (5, 9)), (64, (3, 5)), (37, (5, 9)), (37, (3, 5))]


def make_inputs(width, seed):
    """Target xyz+range and normals [B, H, W, .], source xyz [B, H*W, 3] and
    occupancy. Rows 4-5 of the target are empty, a block of 7 rows x 12
    columns is empty (wider than any window at its centre), and every
    fourth column repeats its left neighbour (ties)."""
    rng = np.random.default_rng(seed)
    tgt = (rng.normal(size=(B, H, width, 4)) * 4.0).astype(np.float32)
    tgt[rng.random((B, H, width)) < 0.2] = 0.0
    tgt[:, 4:6] = 0.0
    tgt[:, 8:15, 10:22] = 0.0
    tgt[:, :, 1::4] = tgt[:, :, 0:width - 1:4][:, :, :tgt[:, :, 1::4].shape[2]]
    nrm = rng.normal(size=(B, H, width, 3)).astype(np.float32)
    src = tgt[..., :3] + rng.normal(size=(B, H, width, 3)).astype(np.float32)
    # Some source points sit exactly on a duplicated target point's mirror
    # image, so two candidates are at exactly equal distance.
    src[:, :, 2::4] = (tgt[:, :, 1::4, :3][:, :, :src[:, :, 2::4].shape[2]])
    occ = rng.random((B, H * width)) < 0.9
    return (src.reshape(B, H * width, 3).astype(np.float32), occ, tgt, nrm)


def pallas_matcher(src, tgt, nrm, window, soft_sigma=0.0):
    wv, wu = window
    a = wv // 2
    occ = np.any(tgt[..., :3] != 0, axis=-1, keepdims=True).astype(np.float32)
    slab = np.pad(np.concatenate([tgt[..., :3], nrm, occ], -1), ((0, 0), (a, a), (0, 0), (0, 0)))
    planes = src.reshape(B, H, -1, 3).transpose(0, 3, 1, 2)
    sq, xyz, nrm_out = window_match_pallas(jnp.asarray(planes),
                                           jnp.asarray(slab.transpose(0, 3, 1, 2)),
                                           wv=wv, wu=wu, interpret=True,
                                           soft_sigma=soft_sigma)
    return (np.asarray(sq), np.asarray(xyz).transpose(0, 2, 3, 1),
            np.asarray(nrm_out).transpose(0, 2, 3, 1))


@pytest.mark.parametrize("width,window", CASES)
def test_plain_matcher_bit_equal_to_pallas_and_xla(width, window):
    src, occ, tgt, nrm = make_inputs(width, seed=width + window[0])
    out = window_match_plain(torch.from_numpy(src).reshape(B, H, width, 3),
                             torch.from_numpy(tgt[..., :3]), torch.from_numpy(nrm), window)
    sq, xyz, nrm_out = (t.numpy() for t in out)
    assert np.isinf(sq).sum() > 0 and np.isfinite(sq).mean() > 0.8

    ref_sq, ref_xyz, ref_nrm = pallas_matcher(src, tgt, nrm, window)
    np.testing.assert_array_equal(sq, ref_sq)
    np.testing.assert_array_equal(xyz, ref_xyz)
    np.testing.assert_array_equal(nrm_out, ref_nrm)

    # The XLA loop's own squared distances and winning offsets.
    spec = jproj.ProjectionSpec(height=H, width=width, **FOV)
    best_k, best_sq, _ = jax.jit(jax.vmap(lambda s, c, o: jcorr.window_match_indices(
        s, jnp.ones(s.shape[0], bool), c, o, spec, window)))(
        jnp.asarray(src), jnp.asarray(tgt[..., :3]), jnp.asarray(np.any(tgt[..., :3] != 0, -1)))
    np.testing.assert_array_equal(sq.reshape(B, -1), np.asarray(best_sq))
    wv, wu = window
    p = np.arange(H * width)
    row = p // width + np.asarray(best_k) // wu - wv // 2
    col = (p % width + np.asarray(best_k) % wu - wu // 2) % width
    found = np.isfinite(np.asarray(best_sq))
    win_xyz = tgt[np.arange(B)[:, None], np.clip(row, 0, H - 1), col, :3]
    np.testing.assert_array_equal(xyz.reshape(B, -1, 3)[found], win_xyz[found])


def test_inputs_hold_exact_ties():
    """The window holds two candidates at exactly the winning distance for
    many pixels, so the first-offset rule is exercised."""
    width, window = 64, (5, 9)
    src, _, tgt, nrm = make_inputs(width, seed=width + window[0])
    src_t = torch.from_numpy(src).reshape(B, H, width, 3)
    best, _, _ = window_match_plain(src_t, torch.from_numpy(tgt[..., :3]),
                                    torch.from_numpy(nrm), window)
    ties = 0
    for du in range(-4, 5):
        for dv in range(-2, 3):
            shifted = np.roll(tgt[..., :3], -du, axis=2)
            shifted = np.roll(shifted, -dv, axis=1)
            d = (shifted - src.reshape(B, H, width, 3)).astype(np.float32)
            sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            ties += int(((sq == best.numpy()) & np.isfinite(sq)).sum())
    assert ties > B * H * width * 1.2        # winners plus exact duplicates


@pytest.mark.parametrize("width,window", CASES[:2])
def test_correspondence_batch_matches_jax_core(width, window):
    src, occ, tgt, nrm = make_inputs(width, seed=3 * width + window[1])
    spec = jproj.ProjectionSpec(height=H, width=width, **FOV)
    ref = jax.jit(jax.vmap(lambda s, o, t, n: jcorr.image_space_correspondence_core(
        s, o, t, n, spec, window)))(*map(jnp.asarray, (src, occ, tgt, nrm)))
    src_t = torch.from_numpy(src).requires_grad_(True)
    out = tcorr.image_space_correspondence_batch(
        src_t, torch.from_numpy(occ), torch.from_numpy(tgt), torch.from_numpy(nrm),
        ProjectionSpec(height=H, width=width, **FOV), window)
    assert out._fields == ref._fields
    for name in ("target_points", "target_normals", "valid"):
        np.testing.assert_array_equal(getattr(out, name).detach().numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(out.sq_dist.detach().numpy(), np.asarray(ref.sq_dist),
                               rtol=1e-6)
    assert not out.valid.all() and out.valid.float().mean() > 0.7
    # Only the recomputed distance carries gradient, to the source points.
    assert not out.target_points.requires_grad
    torch.where(out.valid, out.sq_dist, 0.0).sum().backward()
    expected = 2 * (src - out.target_points.numpy()) * out.valid.numpy()[..., None]
    np.testing.assert_allclose(src_t.grad.numpy(), expected, rtol=1e-6, atol=1e-6)


def test_core_is_the_batch_of_one():
    width, window = 37, (3, 5)
    src, occ, tgt, nrm = make_inputs(width, seed=9)
    spec = ProjectionSpec(height=H, width=width, **FOV)
    args = [torch.from_numpy(a) for a in (src, occ, tgt, nrm)]
    batch = tcorr.image_space_correspondence_batch(*args, spec, window)
    one = tcorr.image_space_correspondence_core(*(a[1] for a in args), spec, window)
    for a, b in zip(one, batch):
        assert torch.equal(a, b[1])


SOFT_CASES = [(64, (5, 9), 0.3), (64, (3, 5), 0.25), (37, (5, 9), 0.25), (37, (3, 5), 0.3)]


def soft_inputs(width, seed, noise=0.3):
    """As :func:`make_inputs`, the source within ``noise`` of the target, so
    that windows blend several candidates; one block of sources is moved 50 m
    off (every weight of its windows underflows: a miss)."""
    src, occ, tgt, nrm = make_inputs(width, seed)
    rng = np.random.default_rng(seed + 1)
    src = (tgt[..., :3] + noise * rng.normal(size=tgt[..., :3].shape)).astype(np.float32)
    src[:, 0:3, 40:44] += 50.0
    return src.reshape(B, H * width, 3), occ, tgt, nrm


@pytest.mark.parametrize("width,window,sigma", SOFT_CASES)
def test_soft_plain_matcher_matches_pallas_and_xla(width, window, sigma):
    src, occ, tgt, nrm = soft_inputs(width, seed=width + window[1])
    sq, xyz, nrm_out = (t.numpy() for t in window_match_soft_plain(
        torch.from_numpy(src).reshape(B, H, width, 3), torch.from_numpy(tgt[..., :3]),
        torch.from_numpy(nrm), window, sigma))
    missed = np.isinf(sq)
    assert missed[:, 0:3, 40:44].all() and missed.any() and (~missed).mean() > 0.6

    ref_sq, ref_xyz, ref_nrm = pallas_matcher(src, tgt, nrm, window, soft_sigma=sigma)
    spec = jproj.ProjectionSpec(height=H, width=width, **FOV)
    core = jax.jit(jax.vmap(lambda s, o, t, n: jcorr.image_space_correspondence_core(
        s, o, t, n, spec, window, soft_sigma=sigma)))(
        *map(jnp.asarray, (src, np.ones_like(occ), tgt, nrm)))
    xla = (np.asarray(core.target_points), np.asarray(core.target_normals))
    np.testing.assert_array_equal(sq, ref_sq)
    np.testing.assert_array_equal(~missed.reshape(B, -1), np.asarray(core.valid))
    for out, pallas, ref in ((xyz, ref_xyz, xla[0]), (nrm_out, ref_nrm, xla[1])):
        np.testing.assert_allclose(out, pallas, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.where(missed[..., None], 0.0, out).reshape(B, -1, 3),
                                   ref, rtol=1e-5, atol=1e-6)


def test_soft_matcher_with_tiny_sigma_is_hard():
    """With every source on a target point and sigma 0.01 m, each window's
    other candidates weigh exp(-100 * sq / 0.01) = 0: the blend is the hard
    winner exactly."""
    width, window = 64, (5, 9)
    _, _, tgt, nrm = make_inputs(width, seed=4)
    dup = tgt[:, :, 1::4, :3]
    dup += np.where(dup != 0, 0.5, 0.0).astype(np.float32)   # no duplicated points
    src = tgt[..., :3].copy()
    args = [torch.from_numpy(a) for a in (src, tgt[..., :3], nrm)]
    soft = window_match_soft_plain(*args, window, 0.01)
    hard = window_match_plain(*args, window)
    occupied = torch.from_numpy((tgt[..., :3] != 0).any(-1))
    assert occupied.float().mean() > 0.5
    for a, b in zip(soft, hard):
        assert torch.equal(a[occupied], b[occupied])


def test_index_search_bit_equal_to_jax():
    """Offsets, squared distances and validity of the reverse direction's
    search, with the candidates' occupancy from a plane: an occupied
    candidate at xyz 0 and an unoccupied one with non-zero xyz follow it."""
    width, window = 64, (5, 9)
    src, occ, tgt, _ = make_inputs(width, seed=11)
    cand_occ = (tgt[..., :3] != 0).any(-1)
    cand_occ[:, 7, 30] = True
    tgt[:, 7, 30, :3] = 0.0
    src.reshape(B, H, width, 3)[:, 7, 30] = 0.01
    cand_occ[:, 9, 50] = False
    tgt[:, 9, 50, :3] = 3.0
    src.reshape(B, H, width, 3)[:, 9, 50] = 3.0
    spec = jproj.ProjectionSpec(height=H, width=width, **FOV)
    ref = jax.jit(jax.vmap(lambda s, o, c, co: jcorr.window_match_indices(
        s, o, c, co, spec, window)))(*map(jnp.asarray, (src, occ, tgt[..., :3], cand_occ)))
    k, sq, valid = tcorr.window_match_indices(
        torch.from_numpy(src), torch.from_numpy(occ), torch.from_numpy(tgt[..., :3]),
        torch.from_numpy(cand_occ.astype(np.float32)), ProjectionSpec(height=H, width=width,
                                                                      **FOV), window)
    for name, a, b in zip(("best_k", "best_sq", "valid"), ref, (k, sq, valid)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    centre = (window[0] // 2) * window[1] + window[1] // 2
    assert (k.reshape(B, H, width)[:, 7, 30] == centre).all()
    assert (sq.reshape(B, H, width)[:, 9, 50] > 0).all()
    plain_k, _ = window_match_indices_plain(
        torch.from_numpy(src).reshape(B, H, width, 3), torch.from_numpy(tgt[..., :3]),
        torch.from_numpy(cand_occ.astype(np.float32)), window)
    assert torch.equal(plain_k.reshape(B, -1), k)


@pytest.mark.parametrize("width,window", CASES[:2])
def test_soft_correspondence_batch_matches_jax_core(width, window):
    src, occ, tgt, nrm = soft_inputs(width, seed=5 * width + window[1])
    spec = jproj.ProjectionSpec(height=H, width=width, **FOV)
    ref = jax.jit(jax.vmap(lambda s, o, t, n: jcorr.image_space_correspondence_core(
        s, o, t, n, spec, window, soft_sigma=0.3)))(*map(jnp.asarray, (src, occ, tgt, nrm)))
    out = tcorr.image_space_correspondence_batch(
        *(torch.from_numpy(a) for a in (src, occ, tgt, nrm)),
        ProjectionSpec(height=H, width=width, **FOV), window, soft_sigma=0.3)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    for name in ("target_points", "target_normals", "sq_dist"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_matcher_rejects_bad_inputs():
    x = torch.zeros(1, 4, 8, 3)
    with pytest.raises(ValueError):
        window_match(x, x, x, (4, 9))
    with pytest.raises(ValueError):
        window_match(x.double(), x.double(), x.double(), (5, 9))
    with pytest.raises(ValueError):
        window_match(x, x[:, :2], x[:, :2], (5, 9))
    with pytest.raises(ValueError):
        window_match(x.to("meta"), x.to("meta"), x.to("meta"), (5, 9))
    with pytest.raises(ValueError):
        window_match_soft(x, x, x, (5, 9), 0.0)
