"""The port's dropout against the Flax model's, on the CPU.

In eval mode (the reference's ``deterministic=True``) the model with
``use_dropout`` equals Flax's within the fp32 model tolerance (rtol 1e-4 /
atol 1e-5). In training mode the masks come from a ``torch.Generator`` and
cannot equal JAX's bits, so the masks are checked by their statistics: a keep
rate of 0.8 within six standard deviations of the binomial count, survivors
divided by 0.8, the stage-3 mask constant over H and W; the same seed gives
the same masks, and the model draws its three masks where the reference does.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu_torch.models import resnet
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.utils.params import params_from_jax
from tests.test_torch_model import make_images, model_kwargs, random_flax_params

KW = dict(model_kwargs("tanh-heads-per_row"), use_dropout=True)
WIDTH = 64


def port_model(params):
    model = OdometryModel(ModelConfig(compute_dtype=torch.float32, **KW))
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.fixture(scope="module")
def flax_params():
    jmodel = JaxOdometryModel(JaxModelConfig(compute_dtype=jnp.float32, **KW))
    return jmodel, random_flax_params(jmodel, WIDTH, seed=2)


def test_eval_mode_equals_flax_deterministic(flax_params):
    jmodel, params = flax_params
    im1, im2 = make_images(WIDTH, seed=3)
    refs = jax.jit(lambda p, a, b: jmodel.apply(p, a, b, deterministic=True))(
        params, jnp.asarray(im1), jnp.asarray(im2))
    model = port_model(params).eval()
    with torch.no_grad():
        outs = model(torch.from_numpy(im1), torch.from_numpy(im2))
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def band(n, keep=0.8):
    return 6.0 * np.sqrt(keep * (1 - keep) / n)


def test_elementwise_mask_statistics():
    x = torch.ones(4, 64, 32, 32)
    out = resnet.dropout(x, 0.2, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.8) < band(x.numel())
    scale = torch.tensor(1.0) / torch.tensor(0.8)
    assert (out[kept] == scale).all()


def test_channel_mask_is_constant_over_the_image():
    x = torch.rand(64, 128, 8, 16, generator=torch.Generator().manual_seed(1)) + 0.5
    out = resnet.dropout(x, 0.2, torch.Generator().manual_seed(2), channels=True)
    kept = out != 0
    per_plane = kept.float().mean((2, 3))
    assert ((per_plane == 0) | (per_plane == 1)).all()
    assert abs(per_plane.mean().item() - 0.8) < band(64 * 128)
    torch.testing.assert_close(out[kept], (x / 0.8)[kept], rtol=0, atol=0)


def test_same_seed_same_masks():
    x = torch.ones(2, 8, 16, 16)
    a = resnet.dropout(x, 0.2, torch.Generator().manual_seed(5))
    b = resnet.dropout(x, 0.2, torch.Generator().manual_seed(5))
    c = resnet.dropout(x, 0.2, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_model_draws_three_masks_in_training_mode(flax_params):
    """Stem input elementwise, after stage 3 by channel, fc output
    elementwise; the same generator seed gives the same output, eval mode
    draws nothing, and training mode without a generator raises."""
    _, params = flax_params
    im1, im2 = (torch.from_numpy(x) for x in make_images(WIDTH, seed=4))
    model = port_model(params).train()
    with mock.patch.object(resnet, "dropout", wraps=resnet.dropout) as spy:
        with torch.no_grad():
            out_a = model(im1, im2, torch.Generator().manual_seed(7))
            out_b = model(im1, im2, torch.Generator().manual_seed(7))
        calls = spy.call_args_list[:3]
        assert spy.call_count == 6
    shapes = [tuple(c.args[0].shape) for c in calls]
    assert shapes[0] == (2, 8, 16, WIDTH) and len(shapes[1]) == 4 and len(shapes[2]) == 2
    assert [c.kwargs.get("channels", False) for c in calls] == [False, True, False]
    assert shapes[1][1] == model.resnet.layer3[-1].conv2.out_channels
    for a, b in zip(out_a, out_b):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        model(im1, im2)
    model.eval()
    with mock.patch.object(resnet, "dropout", wraps=resnet.dropout) as spy:
        with torch.no_grad():
            out_eval = model(im1, im2)
        assert spy.call_count == 0
    assert not torch.equal(out_eval[0], out_a[0])


def test_deterministic_forward_is_eval_and_keeps_the_mode(flax_params):
    """``deterministic=True`` on a model in training mode draws no mask and
    gives the eval-mode output; the loss forward passes the step's flag down
    and leaves the model's mode as the caller set it."""
    from delora_tpu_torch.training.step import forward_pose

    _, params = flax_params
    im1, im2 = (torch.from_numpy(x) for x in make_images(WIDTH, seed=5))
    model = port_model(params).train()
    with mock.patch.object(resnet, "dropout", wraps=resnet.dropout) as spy:
        with torch.no_grad():
            out = model(im1, im2, deterministic=True)
            T = forward_pose(model, im1, im2, deterministic=True)
        assert spy.call_count == 0
    assert model.training
    model.eval()
    with torch.no_grad():
        ref = model(im1, im2)
        T_ref = forward_pose(model, im1, im2, generator=torch.Generator().manual_seed(1))
    assert not model.training
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(T, T_ref)
