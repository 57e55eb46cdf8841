"""The port's model against the Flax model, in float32 on the CPU.

The same Flax params (made from a seed with numpy on the tree that
``model.init`` would build) go through ``params_from_jax`` into the port.
Tolerance rtol 1e-4 / atol 1e-5: the two frameworks sum the convolutions in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.utils.params import params_from_jax, params_to_jax

H = 16

CASES = {
    "tanh-heads-per_row": dict(width=64),
    "relu-single-global": dict(width=64, activation="relu", use_single_mlp=True,
                               quaternion_normalization="global"),
    "tanh-odd-width-multipliers": dict(width=63, stage_width_multipliers=(1.5, 1.0, 1.0, 1.0)),
    "relu-feature-extractor": dict(width=64, activation="relu", pre_feature_extraction=True),
}


def model_kwargs(case):
    kw = dict(resnet_outputs=64, blocks_per_stage=(1, 1, 1, 1), channel_divisor=8)
    kw.update({k: v for k, v in CASES[case].items() if k != "width"})
    return kw


def random_flax_params(model, width, seed):
    """numpy-seeded values on the Flax tree (shapes by eval_shape: no compile),
    scaled by 1/sqrt(fan_in) so tanh does not saturate."""
    x = jnp.zeros((1, H, width, 4), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def make_images(width, seed, batch=2):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(2, batch, H, width, 4)).astype(np.float32) * 5.0
    img[..., 3] = np.abs(img[..., 3])
    img[rng.random((2, batch, H, width)) < 0.2] = 0.0      # empty pixels
    return img[0], img[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_flax_fp32(case):
    kw = model_kwargs(case)
    width = CASES[case]["width"]
    jmodel = JaxOdometryModel(JaxModelConfig(compute_dtype=jnp.float32, **kw))
    params = random_flax_params(jmodel, width, seed=len(case))
    im1, im2 = make_images(width, seed=7)
    t_ref, q_ref = jax.jit(jmodel.apply)(params, jnp.asarray(im1), jnp.asarray(im2))

    model = OdometryModel(ModelConfig(compute_dtype=torch.float32, **kw))
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        t_out, q_out = model(torch.from_numpy(im1), torch.from_numpy(im2))
    assert t_out.dtype == q_out.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(t_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(q_out.numpy(), np.asarray(q_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["tanh-heads-per_row", "relu-single-global",
                                  "relu-feature-extractor"])
def test_params_round_trip_exact(case):
    jmodel = JaxOdometryModel(JaxModelConfig(**model_kwargs(case)))
    params = random_flax_params(jmodel, 64, seed=3)
    back = params_to_jax(params_from_jax(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_state_dict_names_match_port_model():
    """params_from_jax yields exactly the port model's state_dict keys and shapes."""
    kw = model_kwargs("relu-feature-extractor")
    jmodel = JaxOdometryModel(JaxModelConfig(**kw))
    sd = params_from_jax(random_flax_params(jmodel, 64, seed=1))
    ref = OdometryModel(ModelConfig(**kw)).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}


def test_default_init_is_seeded():
    cfg = ModelConfig(**model_kwargs("tanh-heads-per_row"))
    a = OdometryModel(cfg, torch.Generator().manual_seed(5)).state_dict()
    b = OdometryModel(cfg, torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_flax_bf16(case):
    """bf16 (autocast on the port, compute_dtype on Flax) on the same params
    and images: translation and quaternion within 2e-2 of the largest
    magnitude of each, about five bf16 rounding units (2**-8 each). The two
    frameworks round to bf16 at different places; measured worst 5.2e-3."""
    kw = model_kwargs(case)
    width = CASES[case]["width"]
    jmodel = JaxOdometryModel(JaxModelConfig(compute_dtype=jnp.bfloat16, **kw))
    params = random_flax_params(jmodel, width, seed=len(case))
    im1, im2 = make_images(width, seed=7)
    refs = jax.jit(jmodel.apply)(params, jnp.asarray(im1), jnp.asarray(im2))

    model = OdometryModel(ModelConfig(compute_dtype=torch.bfloat16, **kw))
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        outs = model(torch.from_numpy(im1), torch.from_numpy(im2))
    for out, ref in zip(outs, refs):
        ref = np.asarray(ref)
        assert out.dtype == torch.float32
        assert np.abs(out.numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
