"""The port's projective correspondence
(``ops/correspondence.py::projective_correspondence``) against the JAX
package's, on the CPU, and the projective step on the raw feed.

The target is a 16x64 image with a block of empty pixels and duplicated
points; the sources are target points jittered by a few centimetres, points
at the azimuth seam (the window wraps), above and below the field of view
(the window clamps), inside the empty block (no candidate: invalid), on
target points duplicated in their window (exact ties: the first offset wins)
and half way between two target points of one window (bfloat16 near-ties).
Held exactly: the winners (matched points and normals bit-equal) and the
validity; ``sq_dist`` within rtol 1e-6 (recomputed from the live source in
each framework). Near-ties of the selection would be counted; none differ.
The reference ranks the candidates on bfloat16 xyz, and some of the
near-ties pick another winner than a float32 ranking would: the port keeps
the reference's choice.

The step (``loss_and_metrics`` with ``correspondence: projective``) is held
as ``tests/test_torch_step.py::check_step_against_jax`` holds every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.ops.correspondence import projective_correspondence as jax_projective
from delora_tpu.training import step as jstep
from delora_tpu_torch.ops.correspondence import projective_correspondence
from delora_tpu_torch.ops.projection import ProjectionSpec, compute_uv
from delora_tpu_torch.training import step as tstep
from tests.test_step import PSPEC, synthetic_batch
from tests.test_torch_cached_step import params  # noqa: F401  (module fixture)
from tests.test_torch_step import check_step_against_jax

torch.set_num_threads(1)

H, W = PSPEC.height, PSPEC.width
TSPEC = ProjectionSpec(*PSPEC)
WINDOW = (5, 9)
EMPTY = slice(440, 470)        # the sources inside the empty block (see scene)


def pixel_ray(v, u):
    """Unit direction of the centre of pixel (v, u)."""
    az = PSPEC.fov_left + u / (W - 1) * (PSPEC.fov_right - PSPEC.fov_left)
    el = PSPEC.fov_down + v / (H - 1) * (PSPEC.fov_up - PSPEC.fov_down)
    return np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])


def scene(seed, batch=2):
    """Target images, normal images and the source points of the module
    docstring (each kind of source in its own slice)."""
    rng = np.random.default_rng(seed)
    image = np.zeros((batch, H, W, 4), np.float32)
    normals = np.zeros((batch, H, W, 3), np.float32)
    for b in range(batch):
        for v in range(H):
            for u in range(W):
                if rng.random() < 0.25 or (v >= 9 and 20 <= u <= 40):
                    continue
                r = rng.uniform(3.0, 40.0)
                image[b, v, u, :3] = pixel_ray(v, u) * r
                image[b, v, u, 3] = r
                n = rng.normal(size=3)
                normals[b, v, u] = n / np.linalg.norm(n) if rng.random() > 0.2 else 0.0
        # Duplicates: a pixel's point also at its right neighbour (the
        # neighbour's own point is replaced), exact ties of two candidates.
        for v, u in zip(rng.integers(0, 9, 12), rng.integers(0, W - 1, 12)):
            image[b, v, u + 1] = image[b, v, u]
    occupied = [np.argwhere(image[b, ..., 3] > 0) for b in range(batch)]
    src = []
    for b in range(batch):
        occ = occupied[b]
        pick = occ[rng.integers(0, len(occ), 300)]
        near = image[b, pick[:, 0], pick[:, 1], :3] + rng.normal(size=(300, 3)) * 0.05
        seam_u = np.r_[rng.uniform(-0.4, 2.0, 40), rng.uniform(W - 3, W - 0.6, 40)]
        seam = np.stack([pixel_ray(rng.uniform(0, H - 1), u) * rng.uniform(3, 40)
                         for u in seam_u])
        outside_v = np.r_[rng.uniform(-6, -0.6, 30), rng.uniform(H - 0.4, H + 6, 30)]
        outside = np.stack([pixel_ray(v, rng.uniform(0, W - 1)) * rng.uniform(3, 40)
                            for v in outside_v])
        empty = np.stack([pixel_ray(rng.uniform(13.0, 15.0), rng.uniform(26.0, 34.0)) * 10.0
                          for _ in range(30)])
        ties = image[b, pick[:40, 0], pick[:40, 1], :3] * 1.0001
        # Half way between a target point and another one of its window.
        a = occ[rng.integers(0, len(occ), 100)]
        other = np.stack([a[:, 0] + rng.integers(-2, 3, 100),
                          (a[:, 1] + rng.integers(-4, 5, 100)) % W], -1)
        other[:, 0] = np.clip(other[:, 0], 0, H - 1)
        mid = 0.5 * (image[b, a[:, 0], a[:, 1], :3] + image[b, other[:, 0], other[:, 1], :3])
        src.append(np.concatenate([near, seam, outside, empty, ties, mid]).astype(np.float32))
    source = np.stack(src)
    valid = rng.random(source.shape[:2]) > 0.1
    return image, normals, source, valid


def jax_reference(image, normals, source, valid, window=WINDOW):
    fn = jax.jit(jax.vmap(lambda s, m, img, nimg: jax_projective(s, m, img, nimg, PSPEC,
                                                                 window)))
    return [np.asarray(x) for x in fn(source, valid, image, normals)]


@pytest.fixture(scope="module")
def data():
    return scene(0)


@pytest.mark.parametrize("window", [WINDOW, (3, 5), (1, 1)])
def test_projective_correspondence_matches_jax(data, window):
    image, normals, source, valid = data
    ref_pts, ref_nrm, ref_valid, ref_sq = jax_reference(image, normals, source, valid, window)
    out = projective_correspondence(*(torch.from_numpy(x) for x in (source, valid, image,
                                                                    normals)), TSPEC, window)
    out_pts, out_nrm, out_valid, out_sq = (x.numpy() for x in out)
    differ = (out_pts != ref_pts).any(-1) | (out_nrm != ref_nrm).any(-1)
    assert differ.sum() == 0, f"{differ.sum()} of {differ.size} winners differ"
    np.testing.assert_array_equal(out_valid, ref_valid)
    np.testing.assert_allclose(out_sq[ref_valid], ref_sq[ref_valid], rtol=1e-6)
    assert np.isinf(out_sq[~ref_valid]).all() and np.isinf(ref_sq[~ref_valid]).all()
    # Every kind of source took part: matches, misses, both window edges.
    assert 0.5 < ref_valid.mean() < 0.95
    if window == WINDOW:
        assert not ref_valid[:, EMPTY].any()          # the empty block's sources
    u, v = compute_uv(torch.from_numpy(source), TSPEC)
    for mask in (u < window[1] // 2, u > W - 1 - window[1] // 2, v < 0, v > H - 1):
        assert (mask.numpy() & ref_valid).any()


def test_the_selection_ranks_bfloat16_candidates(data):
    """Some sources half way between two target points pick another winner
    under a float32 ranking of the same window; the port picks the
    reference's (bfloat16), which the test above holds equal to JAX's."""
    image, normals, source, valid = data
    out = projective_correspondence(*(torch.from_numpy(x) for x in (source, valid, image,
                                                                    normals)), TSPEC, WINDOW)
    src, img = torch.from_numpy(source), torch.from_numpy(image)
    u, v = compute_uv(src, TSPEC)
    ui = torch.round(u).long().clamp(0, W - 1)
    vi = torch.round(v).long().clamp(0, H - 1)
    batch = torch.arange(src.shape[0])[:, None]
    best = torch.full(src.shape[:2], float("inf"))
    best_pt = torch.zeros_like(src)
    for dv in range(-2, 3):
        for du in range(-4, 5):
            cand = img[batch, (vi + dv).clamp(0, H - 1), torch.remainder(ui + du, W), :3]
            sq = torch.where((cand != 0).any(-1), ((cand - src) ** 2).sum(-1), float("inf"))
            better = sq < best
            best = torch.where(better, sq, best)
            best_pt = torch.where(better[..., None], cand, best_pt)
    moved = (best_pt != out.target_points).any(-1) & out.valid
    assert moved.sum() > 0


@pytest.mark.parametrize("kw", [dict(correspondence="projective"),
                                dict(correspondence="projective", augment=True,
                                     normalization_scaling=True)],
                         ids=["raw-projective", "raw-projective-augment-normalized"])
def test_raw_projective_step_matches_jax(params, kw):  # noqa: F811
    scan_pairs = synthetic_batch(seed=3)[0]
    batch = tstep.ScanPairBatch(*(torch.from_numpy(np.array(x)) for x in scan_pairs))
    check_step_against_jax(jstep.loss_and_metrics, scan_pairs, tstep.loss_and_metrics, batch,
                           params, kw)
