"""The port's packed-rule projection against the JAX package's, on the CPU.

``project_image_packed_batch`` must be bit-equal to the reference's jitted XLA
route and to its Pallas route in interpret mode, with and without the range
channel, and its count of overflowing placement tiles must equal the XLA
route's. Clouds carry 16-bit near-ties: two points of one pixel whose ranges
agree in the top 16 bits but not below, the farther one first, where the
packed rule keeps the farther point and the exact rule the nearer.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.ops import projection as jproj
from delora_tpu_torch.ops import projection as tproj
from delora_tpu_torch.ops.cuda.placement import placement_plain

H = 16
FOV = dict(fov_up=2.0 / 180 * math.pi, fov_down=-24.5 / 180 * math.pi,
           fov_left=-179.9 / 180 * math.pi, fov_right=179.9 / 180 * math.pi)


def specs(width):
    return (jproj.ProjectionSpec(height=H, width=width, **FOV),
            tproj.ProjectionSpec(height=H, width=width, **FOV))


def near_tie_cloud(seed, n, width, batch=2):
    """``n`` points a scan (~2 per pixel, ~5% invalid, some outside the FoV);
    every 8th point is followed by a point on its ray whose range is 1e-4
    shorter in relative terms (same top 16 bits, mostly)."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-math.pi, math.pi, (batch, n))
    el = rng.uniform(FOV["fov_down"] - 0.03, FOV["fov_up"] + 0.03, (batch, n))
    rng_m = rng.uniform(1.0, 60.0, (batch, n))
    rng_m[:, 1::8] = rng_m[:, 0::8][:, :rng_m[:, 1::8].shape[1]] * (1 - 1e-4)
    az[:, 1::8] = az[:, 0::8][:, :az[:, 1::8].shape[1]]
    el[:, 1::8] = el[:, 0::8][:, :el[:, 1::8].shape[1]]
    pts = np.stack([rng_m * np.cos(el) * np.cos(az), rng_m * np.cos(el) * np.sin(az),
                    rng_m * np.sin(el)], axis=-1).astype(np.float32)
    valid = rng.random((batch, n)) > 0.05
    vals = rng.normal(size=(batch, n, 7)).astype(np.float32)
    return pts, valid, vals


def reference(pts, valid, vals, spec, backend, append_range):
    fn = jax.jit(lambda p, m, v: jproj.project_image_packed_batch(
        p, m, spec, values=v, backend=backend, return_overflow=True,
        append_range=append_range))
    image, overflow = fn(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(vals))
    return np.asarray(image), np.asarray(overflow)


@pytest.mark.parametrize("append_range", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_packed_projection_bit_equal_to_jax(backend, append_range):
    width = 64
    jspec, tspec = specs(width)
    pts, valid, vals = near_tie_cloud(seed=1, n=2048, width=width)
    ref_image, ref_overflow = reference(pts, valid, vals, jspec, backend, append_range)
    image, overflow = tproj.project_image_packed_batch(
        torch.from_numpy(pts), torch.from_numpy(valid), tspec, values=torch.from_numpy(vals),
        return_overflow=True, append_range=append_range)
    assert image.shape == (2, H, width, 7 + append_range)
    np.testing.assert_array_equal(image.numpy(), ref_image)
    assert overflow.dtype == torch.int32
    if backend == "xla":
        np.testing.assert_array_equal(overflow.numpy(), ref_overflow)
    assert overflow.tolist() == [0, 0]


def test_near_ties_separate_the_two_rules():
    """The exact rule keeps the nearer point of a 16-bit near-tie, the packed
    rule the first one: on these clouds the two images differ, and the
    reference's packed route agrees with the packed rule only."""
    width = 64
    jspec, tspec = specs(width)
    pts, valid, vals = near_tie_cloud(seed=1, n=2048, width=width)
    ref_image, _ = reference(pts, valid, vals, jspec, "xla", False)
    r, _, _, _, pix = tproj._pixel_coords(torch.from_numpy(pts), torch.from_numpy(valid), tspec)
    args = (pix, r, torch.from_numpy(vals), H, width)
    exact = placement_plain(*args, packed=False, append_range=False).numpy()
    packed = placement_plain(*args, packed=True, append_range=False).numpy()
    np.testing.assert_array_equal(packed, ref_image)
    differing = (exact != ref_image).any(-1).sum()
    assert differing > 20, differing


def test_overflow_count_matches_xla_on_a_crowded_tile():
    """Two 1024-pixel tiles; scan 0 crams 3500 in-FoV points into the first
    (more than the XLA route's 3072-entry window), scan 1 spreads them out."""
    width = 128
    jspec, tspec = specs(width)
    n = 4096
    pts, valid, vals = near_tie_cloud(seed=2, n=n, width=width)
    rng = np.random.default_rng(3)
    # Rows 0-7 of 16 are the first tile: the lower half of the elevations.
    el = rng.uniform(FOV["fov_down"] + 0.01, 0.5 * (FOV["fov_down"] + FOV["fov_up"]) - 0.02, n)
    az = rng.uniform(-math.pi, math.pi, n)
    rr = rng.uniform(2.0, 50.0, n)
    pts[0] = np.stack([rr * np.cos(el) * np.cos(az), rr * np.cos(el) * np.sin(az),
                       rr * np.sin(el)], -1).astype(np.float32)
    valid[0] = np.arange(n) < 3500
    _, ref_overflow = reference(pts, valid, vals, jspec, "xla", False)
    _, overflow = tproj.project_image_packed_batch(
        torch.from_numpy(pts), torch.from_numpy(valid), tspec, values=torch.from_numpy(vals),
        return_overflow=True, append_range=False)
    assert ref_overflow.tolist() == [1, 0]
    np.testing.assert_array_equal(overflow.numpy(), ref_overflow)


def test_packed_rule_needs_fewer_than_65536_pixels():
    spec = tproj.ProjectionSpec(height=64, width=1024, **FOV)
    with pytest.raises(ValueError):
        tproj.project_image_packed_batch(torch.zeros(1, 8, 3), torch.ones(1, 8, dtype=torch.bool),
                                         spec)


def test_plain_packed_winner_rule():
    """Lowest index among the ranges that agree in the top 16 bits; the
    range channel only when asked."""
    r0 = np.array([0x41200010], np.uint32).view(np.float32)[0]   # just above 10
    r1 = np.float32(10.0)                                # same top 16 bits, nearer
    r2 = np.float32(9.0)                                 # clearly nearer
    pix = torch.tensor([[1, 1, 2, 2]], dtype=torch.int32)
    r = torch.tensor([[r0, r1, r0, r2]], dtype=torch.float32)
    vals = torch.arange(4, dtype=torch.float32).reshape(1, 4, 1) + 10
    packed = placement_plain(pix, r, vals, 1, 3, packed=True, append_range=False)
    exact = placement_plain(pix, r, vals, 1, 3, packed=False, append_range=False)
    assert packed.reshape(-1).tolist() == [0.0, 10.0, 13.0]
    assert exact.reshape(-1).tolist() == [0.0, 11.0, 13.0]
    with_range = placement_plain(pix, r, vals, 1, 3, packed=True)
    assert with_range.shape == (1, 1, 3, 2) and with_range[0, 0, 1, 1].item() == r0


def test_plain_packed_rule_above_65536_points_matches_jax():
    """Above 65,536 points a row the kernel keys the packed rule in 64 bits
    (a point index no longer fits in 16); its oracle, the plain version, must
    still equal the reference's jitted packed projection there, 16-bit
    near-ties included. 32 rows of 1024 pixels keep every tile of the XLA
    route under its 3072-entry window, so the reference drops no winner."""
    height, width, n = 32, 1024, 70_000
    jspec = jproj.ProjectionSpec(height=height, width=width, **FOV)
    tspec = tproj.ProjectionSpec(height=height, width=width, **FOV)
    pts, valid, vals = near_tie_cloud(seed=4, n=n, width=width, batch=1)
    fn = jax.jit(lambda p, m, v: jproj.project_image_packed(
        p, m, jspec, values=v, return_overflow=True, append_range=True))
    ref, overflow = fn(jnp.asarray(pts[0]), jnp.asarray(valid[0]), jnp.asarray(vals[0]))
    assert int(overflow) == 0
    image = tproj.project_image_packed_batch(torch.from_numpy(pts), torch.from_numpy(valid),
                                             tspec, values=torch.from_numpy(vals))
    np.testing.assert_array_equal(image[0].numpy(), np.asarray(ref))
    r, _, _, _, pix = tproj._pixel_coords(torch.from_numpy(pts), torch.from_numpy(valid), tspec)
    exact = placement_plain(pix, r, torch.from_numpy(vals), height, width)
    assert (exact[0].numpy() != np.asarray(ref)).any(-1).sum() > 20
