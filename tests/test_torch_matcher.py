"""The port's hard window matcher against the JAX package's, on the CPU.

The plain matcher (what the CPU path runs, and what the CUDA kernel is held
against on the card) must give bit-equal winners to the reference's jitted
XLA loop and to its Pallas kernel in interpret mode: squared distance, target
xyz and target normal. The inputs have empty rows, empty windows (no
candidate: +inf) and duplicated target points, so that exact ties occur and
the first offset must win. ``image_space_correspondence_batch`` must give the
reference's ``Correspondence``: points, normals and validity bit-equal, and
the recomputed ``sq_dist`` within rtol 1e-6 (XLA fuses that sum of squares
with FMAs in an order that depends on its vectorization).
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
from delora_tpu_torch.ops.cuda.window_match import window_match, window_match_plain
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


def pallas_matcher(src, tgt, nrm, window):
    wv, wu = window
    a = wv // 2
    occ = np.any(tgt[..., :3] != 0, axis=-1, keepdims=True).astype(np.float32)
    slab = np.pad(np.concatenate([tgt[..., :3], nrm, occ], -1), ((0, 0), (a, a), (0, 0), (0, 0)))
    planes = src.reshape(B, H, -1, 3).transpose(0, 3, 1, 2)
    sq, xyz, nrm_out = window_match_pallas(jnp.asarray(planes),
                                           jnp.asarray(slab.transpose(0, 3, 1, 2)),
                                           wv=wv, wu=wu, interpret=True)
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


def test_soft_matching_raises():
    src, occ, tgt, nrm = make_inputs(64, seed=1)
    with pytest.raises(NotImplementedError):
        tcorr.image_space_correspondence_batch(
            *(torch.from_numpy(a) for a in (src, occ, tgt, nrm)),
            ProjectionSpec(height=H, width=64, **FOV), (5, 9), soft_sigma=0.3)


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
