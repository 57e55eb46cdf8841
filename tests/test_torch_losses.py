"""The port's ICP losses and host projection against the JAX package's, on
the CPU.

Losses: every value within rtol 1e-6 and every gradient (to the source points
and source normals) within rtol 1e-5 / atol 1e-7 of ``jax.grad``, across the
loss options; the inputs are unit scale, so those are a few float32 ulps.
Host artifacts: bit-equal to ``delora_tpu/ops/projection_host.py`` without the
native projection.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.losses import icp as jicp
from delora_tpu.ops import correspondence as jcorr
from delora_tpu.ops import projection as jproj
from delora_tpu.ops import projection_host as jhost
from delora_tpu_torch.losses import icp as ticp
from delora_tpu_torch.ops import correspondence as tcorr
from delora_tpu_torch.ops import projection as tproj
from delora_tpu_torch.ops import projection_host as thost

S, B = 300, 2
OPTIONS = {
    "defaults": dict(),
    "linear-normals": dict(normal_loss="linear"),
    "po2po-and-weights": dict(point_to_point=True, lambda_po2pl=0.5, lambda_pl2pl=0.3),
    "po2po-alone": dict(po2po_alone=True),
    "trim": dict(trim_sq_distance=0.2),
    "po2pl-only": dict(plane_to_plane=False),
}


def loss_inputs(seed):
    """Unit-scale pairs; a third of the normals are zero ("no normal") on
    each side, ~10% of pairs invalid."""
    rng = np.random.default_rng(seed)

    def normals():
        n = rng.normal(size=(B, S, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        n[rng.random((B, S)) < 0.33] = 0.0
        return n

    src = rng.normal(size=(B, S, 3)).astype(np.float32)
    tgt = (src + 0.3 * rng.normal(size=(B, S, 3))).astype(np.float32)
    src_nrm, tgt_nrm = normals(), normals()
    src_valid = rng.random((B, S)) > 0.05
    corr_valid = rng.random((B, S)) > 0.05
    tgt = np.where(corr_valid[..., None], tgt, 0.0).astype(np.float32)
    tgt_nrm = np.where(corr_valid[..., None], tgt_nrm, 0.0).astype(np.float32)
    sq = np.where(corr_valid, ((src - tgt) ** 2).sum(-1), np.inf).astype(np.float32)
    return src, src_nrm, src_valid, tgt, tgt_nrm, corr_valid, sq


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_icp_losses_and_grads_match_jax(name):
    src, src_nrm, src_valid, tgt, tgt_nrm, corr_valid, sq = loss_inputs(seed=len(name))
    jcfg = jicp.IcpLossConfig(**OPTIONS[name])
    tcfg = ticp.IcpLossConfig(**OPTIONS[name])

    def jax_losses(s, n):
        corr = jcorr.Correspondence(jnp.asarray(tgt), jnp.asarray(tgt_nrm),
                                    jnp.asarray(corr_valid), jnp.asarray(sq))
        return jax.vmap(lambda *a: jicp.icp_losses(*a[:3], jcorr.Correspondence(*a[3:]),
                                                   jcfg))(s, n, jnp.asarray(src_valid), *corr)

    ref = jax.jit(jax_losses)(jnp.asarray(src), jnp.asarray(src_nrm))
    grad_s, grad_n = jax.jit(jax.grad(lambda s, n: jnp.sum(jax_losses(s, n)["loss_pc"]),
                                      argnums=(0, 1)))(jnp.asarray(src), jnp.asarray(src_nrm))

    s_t = torch.from_numpy(src).requires_grad_(True)
    n_t = torch.from_numpy(src_nrm).requires_grad_(True)
    corr = tcorr.Correspondence(*map(torch.from_numpy, (tgt, tgt_nrm, corr_valid, sq)))
    out = ticp.icp_losses(s_t, n_t, torch.from_numpy(src_valid), corr, tcfg)
    assert sorted(out) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, err_msg=key)
    assert (np.asarray(ref["num_po2pl_pairs"]) > 50).all()
    out["loss_pc"].sum().backward()
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(grad_s), rtol=1e-5, atol=1e-7)
    # Where the value does not depend on the normals (po2po alone, no pl2pl)
    # torch leaves no gradient and JAX gives zeros.
    grad_n_out = np.zeros_like(src_nrm) if n_t.grad is None else n_t.grad.numpy()
    np.testing.assert_allclose(grad_n_out, np.asarray(grad_n), rtol=1e-5, atol=1e-7)


def test_masked_mse_empty_mask_is_zero():
    resid = torch.ones(2, 5)
    mask = torch.zeros(2, 5, dtype=torch.bool)
    mask[1, :2] = True
    out = ticp.masked_mse(resid * 3.0, mask)
    assert out.tolist() == [0.0, 3.0]
    ref = jicp.masked_mse(jnp.full((5,), 3.0), jnp.zeros(5, bool))
    assert float(ref) == 0.0


def test_icp_config_from_config():
    config = {"point_to_point_loss": True, "point_to_plane_loss": True,
              "plane_to_plane_loss": False, "normal_loss": "linear", "lambda_po2pl": 2.0,
              "po2pl_trim_distance": 0.5, "lambda_pl2pl": 0.5}
    assert tuple(ticp.IcpLossConfig.from_config(config)) == tuple(
        jicp.IcpLossConfig.from_config(config))


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_artifacts_bit_equal_to_jax(seed):
    H, W, N = 16, 64, 3000
    fov = dict(fov_up=2.0 / 180 * math.pi, fov_down=-24.5 / 180 * math.pi,
               fov_left=-179.9 / 180 * math.pi, fov_right=179.9 / 180 * math.pi)
    rng = np.random.default_rng(seed)
    az = rng.uniform(-math.pi, math.pi, N)
    el = rng.uniform(fov["fov_down"] - 0.05, fov["fov_up"] + 0.05, N)
    rr = rng.uniform(1.0, 60.0, N)
    pts = np.stack([rr * np.cos(el) * np.cos(az), rr * np.cos(el) * np.sin(az),
                    rr * np.sin(el)], -1).astype(np.float32)
    pts[rng.choice(N, 300)] = pts[rng.choice(N, 300)]          # exact range ties
    normals = rng.normal(size=(N, 3)).astype(np.float32)
    valid = rng.random(N) > 0.1
    ref = jhost.scan_artifacts_np(pts, normals, valid, jproj.ProjectionSpec(H, W, **fov),
                                  use_native=False)
    out = thost.scan_artifacts_np(pts, normals, valid, tproj.ProjectionSpec(H, W, **fov))
    assert out._fields == ref._fields
    for name, a, b in zip(ref._fields, ref, out):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)
    assert 0 < out.src_valid.sum() < H * W
