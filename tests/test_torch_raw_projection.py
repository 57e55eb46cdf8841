"""The raw feed's projections against the JAX package's, on the CPU.

``project_scan_batch`` (image, survivor flags, pixel -> point map, pixel
coordinates) against jitted ``vmap(project_scan)``; ``gather_image_attribute``;
``project_compact_exact_batch`` (image, compacted winners, mask) against the
reference's XLA route and its Pallas route in interpret mode; and the train
step's re-projection at H*W >= 65536 (``_warped_image``'s exact-rule branch)
against jitted ``vmap(project_scan)(...)[..., 3:10]``, as the reference's step
takes it there. All bit-equal: the placement's exact rule is the reference's
stable (pixel, range, index) sort. The compacted rows past each scan's winner
count hold junk in the reference and zeros in the port, so those rows are
compared under the mask.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.ops import projection as jproj
from delora_tpu_torch.ops import projection as tproj
from delora_tpu_torch.training.step import _warped_image
from tests.test_torch_projection import FOV, JSPEC, TSPEC, make_cloud

B = 2


def test_project_scan_batch_bit_equal_to_jax():
    pts, valid = make_cloud(4, n=4096, batch=(B,))
    ref = jax.jit(jax.vmap(lambda p, m: jproj.project_scan(p, m, JSPEC)))(
        jnp.asarray(pts), jnp.asarray(valid))
    out = tproj.project_scan_batch(torch.from_numpy(pts), torch.from_numpy(valid), TSPEC)
    assert out._fields == ref._fields
    for name in out._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert out.survivor.sum() == (out.point_index >= 0).sum() > 1000


def test_gather_image_attribute_matches_jax():
    pts, valid = make_cloud(5, n=4096, batch=(B,))
    nrm = np.random.default_rng(5).normal(size=pts.shape).astype(np.float32)
    proj = tproj.project_scan_batch(torch.from_numpy(pts), torch.from_numpy(valid), TSPEC)
    ref = jax.vmap(jproj.gather_image_attribute)(jnp.asarray(nrm),
                                                 jnp.asarray(proj.point_index.numpy()))
    out = tproj.gather_image_attribute(torch.from_numpy(nrm), proj.point_index)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("n", [4096, 700])
def test_project_compact_exact_batch_bit_equal_to_jax(backend, n):
    """n = 700 < H*W: the compaction's capacity is N."""
    pts, valid = make_cloud(6 + n, n=n, batch=(B,))
    vals = np.concatenate([pts, np.random.default_rng(n).normal(size=pts.shape)], -1)
    vals = vals.astype(np.float32)
    ref = jax.jit(lambda p, m, v: jproj.project_compact_exact_batch(
        p, m, JSPEC, values=v, backend=backend))(*map(jnp.asarray, (pts, valid, vals)))
    out = tproj.project_compact_exact_batch(*map(torch.from_numpy, (pts, valid)), TSPEC,
                                            values=torch.from_numpy(vals))
    np.testing.assert_array_equal(out.image.numpy(), np.asarray(ref.image))
    mask = np.asarray(ref.comp_mask)
    np.testing.assert_array_equal(out.comp_mask.numpy(), mask)
    np.testing.assert_array_equal(out.comp_vals.numpy()[mask], np.asarray(ref.comp_vals)[mask])
    assert (out.comp_vals.numpy()[~mask] == 0).all() and mask.sum() > 0.3 * min(n, 1024)


def test_warped_image_exact_rule_branch_bit_equal_to_jax():
    """At 64x1024 (H*W = 65536) the step re-projects the warped source under
    the exact rule: 1-4 points on each of ~12,000 rays, some at exactly equal
    ranges and some 1e-6 nearer, with 7 payload channels."""
    spec_t = tproj.ProjectionSpec(height=64, width=1024, **FOV)
    spec_j = jproj.ProjectionSpec(height=64, width=1024, **FOV)
    rng = np.random.default_rng(12)
    rays = 12000
    az = rng.uniform(-math.pi, math.pi, (B, rays))
    el = rng.uniform(FOV["fov_down"], FOV["fov_up"], (B, rays))
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    per_ray = rng.integers(1, 5, (B, rays))
    r = rng.uniform(2.0, 60.0, (B, rays, 4))
    r[..., 1] = np.where(rng.random((B, rays)) < 0.3, r[..., 0], r[..., 1])        # ties
    r[..., 2] = np.where(rng.random((B, rays)) < 0.3, r[..., 0] * (1 - 1e-6), r[..., 2])
    keep = np.arange(4) < per_ray[..., None]
    pos = (d[:, :, None, :] * r[..., None]).astype(np.float32)
    n = int(keep.sum(axis=(1, 2)).max())
    pos_sel = np.zeros((B, n, 3), np.float32)
    src_valid = np.zeros((B, n), bool)
    for b in range(B):
        kept = pos[b][keep[b]]
        order = rng.permutation(len(kept))
        pos_sel[b, :len(kept)] = kept[order]
        src_valid[b, :len(kept)] = True
    vals = rng.normal(size=(B, n, 7)).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda pv, m: jproj.project_scan(pv, m, spec_j).image[..., 3:10]))(
        jnp.asarray(np.concatenate([pos_sel, vals], -1)), jnp.asarray(src_valid))
    out, overflow = _warped_image(*map(torch.from_numpy, (pos_sel, src_valid, vals)), spec_t)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert overflow.item() == 0.0 and (np.asarray(ref) != 0).any(-1).mean() > 0.1
