"""The port's projection against the JAX package's, on the CPU.

The JAX functions run jitted, as the serving path runs them (XLA folds the
division by the FoV span into one f32 factor and contracts x*x + y*y into an
FMA; the port reproduces both). The Pallas placement runs in interpret mode,
as tests/test_projection.py runs it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.ops import projection as jproj
from delora_tpu_torch.ops import projection as tproj
from delora_tpu_torch.ops.cuda.placement import placement, placement_plain

H, W = 16, 64
FOV = dict(fov_up=2.0 / 180 * math.pi, fov_down=-24.5 / 180 * math.pi,
           fov_left=-179.9 / 180 * math.pi, fov_right=179.9 / 180 * math.pi)
JSPEC = jproj.ProjectionSpec(height=H, width=W, **FOV)
TSPEC = tproj.ProjectionSpec(height=H, width=W, **FOV)


def make_cloud(seed, n=4096, batch=()):
    """Points over the FoV (and a margin outside it): about 2-6 per pixel,
    with exact duplicates so that (pixel, range) ties occur, and ~5% invalid."""
    rng = np.random.default_rng(seed)
    shape = batch + (n,)
    az = rng.uniform(-math.pi, math.pi, shape)
    el = rng.uniform(FOV["fov_down"] - 0.05, FOV["fov_up"] + 0.05, shape)
    rng_m = rng.uniform(1.0, 60.0, shape)
    pts = np.stack([rng_m * np.cos(el) * np.cos(az), rng_m * np.cos(el) * np.sin(az),
                    rng_m * np.sin(el)], axis=-1).astype(np.float32)
    flat = pts.reshape(-1, n, 3)
    for b in range(flat.shape[0]):
        dst = rng.choice(n, n // 8, replace=False)
        flat[b, dst] = flat[b, rng.choice(n, n // 8)]
    valid = rng.random(shape) > 0.05
    return pts, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_pixel_coords_match_jax(seed):
    pts, valid = make_cloud(seed, n=4096)
    ref = jax.jit(lambda p, m: jproj._pixel_coords(p, m, JSPEC))(
        jnp.asarray(pts), jnp.asarray(valid))
    out = tproj._pixel_coords(torch.from_numpy(pts), torch.from_numpy(valid), TSPEC)
    for name, a, b in zip(("r", "u", "v", "in_fov", "pix"), ref, out):
        mismatches = int((np.asarray(a) != b.numpy()).sum())
        assert mismatches == 0, f"{name}: {mismatches} of {a.size} differ"


@pytest.mark.parametrize("seed", [2, 3])
def test_project_image_bit_equal_to_jax(seed):
    pts, valid = make_cloud(seed, n=4096)
    ref = jax.jit(lambda p, m: jproj.project_image(p, m, JSPEC))(
        jnp.asarray(pts), jnp.asarray(valid))
    out = tproj.project_image(torch.from_numpy(pts), torch.from_numpy(valid), TSPEC)
    assert out.shape == (H, W, 4) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_placement_bit_equal_to_jax_compact_exact_batch(backend):
    """Batched, with an index-coded payload, so that the tie-break among
    duplicate (pixel, range) entries shows: the lowest index must win."""
    B, N = 2, 4096
    pts, valid = make_cloud(4, n=N, batch=(B,))
    vals = (np.arange(B * N * 3, dtype=np.float32).reshape(B, N, 3)
            * np.float32(0.5))
    ref = jax.jit(lambda p, m, v: jproj.project_compact_exact_batch(
        p, m, JSPEC, values=v, backend=backend).image)(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(vals))
    r, _, _, _, pix = tproj._pixel_coords(
        torch.from_numpy(pts), torch.from_numpy(valid), TSPEC)
    keys = set()
    ties = 0
    for b in range(B):
        for p, rr in zip(pix[b].tolist(), r[b].tolist()):
            if p < H * W:
                ties += (p, rr) in keys
                keys.add((p, rr))
    assert ties > 100
    out = placement(pix, r, torch.from_numpy(vals), H, W)
    assert out.shape == (B, H, W, 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    occupied = out.numpy()[..., 3] > 0
    assert 0.5 < occupied.mean() < 1.0


def test_placement_rejects_bad_inputs():
    pix = torch.zeros(1, 8, dtype=torch.int32)
    r = torch.ones(1, 8)
    vals = torch.ones(1, 8, 3)
    with pytest.raises(ValueError):
        placement(pix.long(), r, vals, 2, 4)
    with pytest.raises(ValueError):
        placement(pix, r[:, :4], vals, 2, 4)
    with pytest.raises(ValueError):
        placement(pix, r, vals[0], 2, 4)
    with pytest.raises(ValueError):
        placement(pix.to("meta"), r.to("meta"), vals.to("meta"), 2, 4)


def test_placement_plain_winner_rule():
    """Smallest range wins; equal ranges go to the lowest index; culled ids
    (< 0 or >= H*W) are dropped; empty pixels are zero."""
    pix = torch.tensor([[1, 1, 1, 3, 4, -1, 0]], dtype=torch.int32)
    r = torch.tensor([[5.0, 2.0, 2.0, 7.0, 1.0, 0.5, 9.0]])
    vals = torch.arange(7, dtype=torch.float32).reshape(1, 7, 1) + 10
    out = placement_plain(pix, r, vals, 2, 2).reshape(4, 2)
    np.testing.assert_array_equal(
        out.numpy(), [[16.0, 9.0], [11.0, 2.0], [0.0, 0.0], [13.0, 7.0]])
