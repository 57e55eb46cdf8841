"""The port's normal estimation (``delora_tpu_torch/ops/normals.py``)
against the JAX package's (``delora_tpu/ops/normals.py``), jitted, on the
same range images: planar patches, a ray-cast street with holes and an
isolated pixel, at the 5x7 and 7x11 patches.

The "has a normal" masks must be identical: the neighbour counts are exact
integer sums. The covariances handed to the eigensolver must be bit-equal to
the reference's (its own code, jitted). The normals agree within
4e-6 * kappa, kappa = |lambda|_max / (lambda_2 - lambda_1) of that float32
covariance, the eigensolver's tolerance of ``tests/test_torch_eigh3.py``,
wherever kappa <= 300. Beyond, the two smallest eigenvalues lie within 0.3%
of the largest (a neighbourhood whose points lie on a line), the
trigonometric solver's error near a double root grows as the square root of
the float32 epsilon in both implementations, and the normal is set by
rounding: there the test holds the port's normal to unit length and to the
sensor-facing side only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.ops import normals as jnormals
from delora_tpu.ops.projection import ProjectionSpec as JSpec
from delora_tpu.ops.projection import project_scan
from delora_tpu_torch.ops import normals as tnormals
from delora_tpu_torch.ops.projection import ProjectionSpec, project_scan_batch

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)

PATCHES = [(5, 7), (7, 11)]
KAPPA_HELD = 300.0
FOV = dict(fov_up=np.deg2rad(2.0), fov_down=np.deg2rad(-24.5), fov_left=-np.pi,
           fov_right=np.pi)


def plane_image(H=16, W=32, normal=(0.2, 0.1, 1.0), d=-2.0):
    n = np.asarray(normal) / np.linalg.norm(normal)
    xs, ys = np.meshgrid(np.linspace(2.0, 6.0, W), np.linspace(-2.0, 2.0, H))
    zs = (d - n[0] * xs - n[1] * ys) / n[2]
    img = np.stack([xs, ys, zs], -1).astype(np.float32)
    img[5:9, 10:20] = 0.0                      # a hole
    return img


def street_points(rng, rings=16, steps=256):
    """Ray-cast ground, two facades and a far wall, 2 cm range noise."""
    el = np.deg2rad(np.linspace(-24.0, 1.5, rings))
    az = np.linspace(-np.pi, np.pi, steps, endpoint=False)
    e, a = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1).reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.stack([np.where(d[:, 2] < 0, -1.73 / d[:, 2], np.inf),
                      np.where(d[:, 1] < 0, -7.0 / d[:, 1], np.inf),
                      np.where(d[:, 1] > 0, 9.0 / d[:, 1], np.inf),
                      np.where(d[:, 0] > 0, 40.0 / d[:, 0], np.inf)]).min(0)
    keep = (t < 60.0) & (rng.random(len(t)) > 0.1)
    t = t[keep] + rng.normal(0, 0.02, keep.sum())
    return (d[keep] * t[:, None]).astype(np.float32)


def street_image(rings=16, steps=256):
    pts = street_points(np.random.default_rng(0), rings, steps)
    spec = JSpec(height=rings, width=steps, **FOV)
    proj = jax.jit(project_scan, static_argnums=2)(
        jnp.asarray(pts), jnp.ones(len(pts), bool), spec)
    return np.asarray(proj.image[..., :3])


def isolated_image():
    img = np.zeros((16, 32, 3), np.float32)
    img[8, 16] = (4.0, 0.1, -1.0)
    return img


IMAGES = {"plane": (plane_image(), 5.0), "street": (street_image(), 0.5),
          "isolated": (isolated_image(), 0.5)}


def reference_covariance(img, spec):
    """The covariance the reference hands its eigensolver, by the reference's
    own code (delora_tpu/ops/normals.py:79-103), jitted -> (count, cov)."""
    a, b = spec.patch_v // 2, spec.patch_u // 2
    H, W, _ = img.shape
    center_range = jnp.linalg.norm(img, axis=-1)
    padded = jnp.pad(img, ((a, a), (b, b), (0, 0)), mode="edge")

    def body(k, carry):
        count, s1, s2 = carry
        nb = jax.lax.dynamic_slice(padded, (k // spec.patch_u, k % spec.patch_u, 0), (H, W, 3))
        ok = jnp.any(nb != 0.0, axis=-1) & (
            jnp.abs(jnp.linalg.norm(nb, axis=-1) - center_range) <= spec.epsilon_range)
        w = ok.astype(img.dtype)[..., None]
        nbw = nb * w
        return count + w[..., 0], s1 + nbw, s2 + nbw[..., :, None] * nb[..., None, :]

    n, s1, s2 = jax.lax.fori_loop(0, spec.patch_v * spec.patch_u, body, (
        jnp.zeros((H, W)), jnp.zeros((H, W, 3)), jnp.zeros((H, W, 3, 3))))
    n_safe = jnp.maximum(n, 2.0)
    mean = s1 / n_safe[..., None]
    cov = (s2 - n_safe[..., None, None] * mean[..., :, None] * mean[..., None, :])
    return n, cov / (n_safe - 1.0)[..., None, None]


_jit_covariance = jax.jit(reference_covariance, static_argnums=1)


def port_covariance(img, spec, monkeypatch):
    """The port's normal image and the covariance it hands its eigensolver."""
    seen = []

    def spy(A, eps=1e-20):
        seen.append(A)
        return solver(A, eps)

    solver = tnormals.smallest_eigenvector_sym3x3
    monkeypatch.setattr(tnormals, "smallest_eigenvector_sym3x3", spy)
    out = tnormals.compute_normal_image(torch.from_numpy(img), spec).numpy()
    monkeypatch.undo()
    return out, seen[0].numpy()


def conditioning(cov):
    """kappa = |lambda|_max / (lambda_2 - lambda_1) of float32 covariances."""
    w = np.linalg.eigvalsh(cov.astype(np.float64))
    return np.abs(w).max(-1) / np.maximum(w[..., 1] - w[..., 0], 1e-30)


_jit_normals = jax.jit(jnormals.compute_normal_image, static_argnums=1)


@pytest.mark.parametrize("patch", PATCHES, ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("name", sorted(IMAGES))
def test_normal_image_matches_jax(name, patch, monkeypatch):
    img, eps = IMAGES[name]
    img = img.copy()
    spec = tnormals.NormalsSpec(patch[0], patch[1], eps, 10)
    ref = np.asarray(_jit_normals(jnp.asarray(img), jnormals.NormalsSpec(*spec)))
    out, cov = port_covariance(img, spec, monkeypatch)
    _, ref_cov = _jit_covariance(jnp.asarray(img), spec)
    np.testing.assert_array_equal(cov, np.asarray(ref_cov))
    has = (ref != 0).any(-1)
    np.testing.assert_array_equal((out != 0).any(-1), has)
    if name == "isolated":
        assert not has.any()
        return
    assert has.sum() > 100
    diff = np.abs(out - ref).max(-1)
    kappa = conditioning(cov)
    held = has & (kappa <= KAPPA_HELD)
    assert held.sum() > 0.7 * has.sum()
    assert (diff[held] <= 4e-6 * kappa[held]).all(), f"worst {diff[held].max()}"
    np.testing.assert_allclose(np.linalg.norm(out[has], axis=-1), 1.0, atol=1e-5)
    # Turned toward the sensor.
    assert ((out * img).sum(-1)[has] <= 1e-4).all()


def test_normals_for_points_match_jax(monkeypatch):
    """Per point: the normal at its own pixel, zero for the points that lost
    their pixel; the projections are the jitted reference's and the port's."""
    rng = np.random.default_rng(1)
    pts = street_points(rng, 16, 128)
    pts = np.concatenate([pts, pts[:200] * 1.001])          # duplicates lose their pixel
    valid = np.ones(len(pts), bool)
    spec = tnormals.NormalsSpec(5, 7, 0.5, 10)
    jspec = JSpec(height=16, width=128, **FOV)

    @jax.jit
    def ref_fn(p, m):
        proj = project_scan(p, m, jspec)
        return jnormals.normals_for_points(proj.image[..., :3], proj,
                                           jnormals.NormalsSpec(*spec)), proj.survivor

    ref, ref_survivor = (np.asarray(x) for x in ref_fn(jnp.asarray(pts), jnp.asarray(valid)))
    tspec = ProjectionSpec(height=16, width=128, **FOV)
    proj = project_scan_batch(torch.from_numpy(pts)[None], torch.from_numpy(valid)[None], tspec)
    out = tnormals.normals_for_points(proj.image[0, ..., :3], proj.u[0], proj.v[0],
                                      proj.survivor[0], spec).numpy()
    _, cov = port_covariance(proj.image[0, ..., :3].numpy(), spec, monkeypatch)
    np.testing.assert_array_equal(proj.survivor[0].numpy(), ref_survivor)
    assert (out[~ref_survivor] == 0).all() and (ref[~ref_survivor] == 0).all()
    has = (ref != 0).any(-1)
    np.testing.assert_array_equal((out != 0).any(-1), has)
    u = np.clip(np.round(proj.u[0].numpy()).astype(int), 0, 127)
    v = np.clip(np.round(proj.v[0].numpy()).astype(int), 0, 15)
    kappa = conditioning(cov).reshape(-1)[v * 128 + u]
    held = has & (kappa <= KAPPA_HELD)
    assert held.sum() > 0.7 * has.sum()
    assert (np.abs(out - ref).max(-1)[held] <= 4e-6 * kappa[held]).all()
