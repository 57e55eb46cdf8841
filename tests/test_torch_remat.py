"""``remat`` and ``fused_adam`` in the port, on the CPU.

``remat`` recomputes each ResNet block in the backward pass
(``torch.utils.checkpoint``). On the CPU a recomputed block gives the same
bits, so the outputs and every gradient equal those without it bit for bit,
with dropout on and the same generator seed (no dropout site lies inside a
block), in float32 and under bfloat16 autocast. The state_dict keeps its
names, and ``utils/params.py`` loads the same JAX params (from the
reference's model with and without ``remat``, whose trees are equal) into
both.

``fused_adam`` runs the same foreach update as without it; it is held bit
for bit against per-tensor Adam (``foreach=False``) and within rtol 1e-6 /
atol 1e-6 * max|p| against optax's ``flatten(adam)`` (the reference's fused
update), the tolerance of the port's other Adam tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu.training.state import make_optimizer as jax_make_optimizer
from delora_tpu_torch.config import default_config
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.training.state import make_optimizer
from delora_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(1)

NARROW = dict(resnet_outputs=16, blocks_per_stage=(2, 1, 1, 2), channel_divisor=16)


def forward_backward(model, images, seed):
    """Outputs and parameter gradients of one training-mode forward with
    dropout masks from a generator seeded ``seed``."""
    model.zero_grad(set_to_none=True)
    translation, quat = model(*images, torch.Generator().manual_seed(seed))
    (translation.square().sum() + (quat * torch.arange(1.0, 5.0)).sum()).backward()
    return (translation.detach(), quat.detach(),
            {k: p.grad.clone() for k, p in model.named_parameters()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_remat_is_bit_equal_to_no_remat(dtype):
    rng = np.random.default_rng(0)
    images = [torch.from_numpy(rng.normal(size=(2, 16, 64, 4)).astype(np.float32))
              for _ in range(2)]
    plain = OdometryModel(ModelConfig(compute_dtype=dtype, use_dropout=True, **NARROW),
                          torch.Generator().manual_seed(1)).train()
    remat = OdometryModel(ModelConfig(compute_dtype=dtype, use_dropout=True, remat=True,
                                      **NARROW)).train()
    remat.load_state_dict(plain.state_dict())
    assert remat.resnet.remat and not plain.resnet.remat
    t0, q0, g0 = forward_backward(plain, images, seed=5)
    t1, q1, g1 = forward_backward(remat, images, seed=5)
    assert torch.equal(t0, t1) and torch.equal(q0, q1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    # Dropout drew masks: another seed moves the outputs.
    t2, _, _ = forward_backward(remat, images, seed=6)
    assert not torch.equal(t1, t2)


def test_remat_keeps_the_state_dict_and_loads_the_same_jax_params():
    config = default_config({"layers": [2, 1, 1, 2], "factor_fewer_resnet_channels": 16,
                             "resnet_outputs": 16, "remat": True})
    remat = OdometryModel(ModelConfig.from_config(config))
    plain = OdometryModel(ModelConfig.from_config(dict(config, remat=False)))
    assert remat.cfg.remat and not plain.cfg.remat
    assert list(remat.state_dict()) == list(plain.state_dict())
    assert "resnet.layer1.1.conv2.weight" in remat.state_dict()
    x = jnp.zeros((1, 16, 64, 4), jnp.float32)
    trees = []
    for flag in (False, True):
        jmodel = JaxOdometryModel(JaxModelConfig(compute_dtype=jnp.float32, remat=flag,
                                                 **NARROW))
        trees.append(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x))
    assert jax.tree_util.tree_structure(trees[0]) == jax.tree_util.tree_structure(trees[1])
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), trees[1])
    for model in (remat, plain):
        model.load_state_dict(params_from_jax(params))
    for (name, a), b in zip(remat.state_dict().items(), plain.state_dict().values()):
        assert torch.equal(a, b), name


def adam_runs(config, grads, w0, **torch_kw):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    if torch_kw:
        optimizer = torch.optim.Adam(list(params.values()), lr=config["learning_rate"],
                                     betas=(0.9, 0.999), eps=1e-8, **torch_kw)
    else:
        optimizer, _ = make_optimizer(config, list(params.values()), 8)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
    return {k: p.detach().numpy() for k, p in params.items()}


def test_fused_adam_equals_per_tensor_adam_and_optax_flatten():
    config = {"learning_rate": 1e-3, "fused_adam": True}
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 3)}
    w0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-5, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    fused = adam_runs(config, grads, w0)
    per_tensor = adam_runs(config, grads, w0, foreach=False)
    for k in shapes:
        np.testing.assert_array_equal(fused[k], per_tensor[k], err_msg=k)
        assert not np.array_equal(fused[k], w0[k])

    tx = jax_make_optimizer(config, 8)
    jparams = {k: jnp.asarray(v) for k, v in w0.items()}
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for k in shapes:
        ref = np.asarray(jparams[k])
        np.testing.assert_allclose(fused[k], ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                   err_msg=k)
