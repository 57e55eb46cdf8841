"""Weights in the original DeLORA ``.pth`` layout, both ways, against the JAX
package's ``delora_tpu/utils/torch_import.py``, on both heads (two MLPs, and
the single 512-512-256-64-7 MLP).

Held: a file the JAX package writes from Flax params loads into the port
bit-equal to ``params_from_jax`` and gives the Flax model's pose within the
model tolerance (rtol 1e-4, atol 1e-5 in float32: the two frameworks sum the
convolutions in different orders); a file the port writes is read by the
JAX package bit-equal to ``params_to_jax``; a missing, renamed or misshapen
weight raises; ``cli export-torch`` writes a port checkpoint's live weights
bit-equal to the JAX package's ``params_to_torch_state_dict`` of the same
params, with the checkpoint's epoch, loss and config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu.utils import torch_import as jax_torch_import
from delora_tpu_torch import cli
from delora_tpu_torch.config import default_config
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.serving.stream import StreamingOdometry
from delora_tpu_torch.training.checkpoint import CheckpointManager
from delora_tpu_torch.utils.params import params_from_jax, params_to_jax
from delora_tpu_torch.utils.torch_import import (
    load_reference_checkpoint,
    save_reference_checkpoint,
)
from tests.test_torch_model import make_images, random_flax_params

torch.set_num_threads(1)

HEADS = {
    "two_mlps": {"activation_fct": "tanh", "use_single_mlp_at_output": False,
                 "quaternion_normalization": "per_row"},
    "single_mlp": {"activation_fct": "relu", "use_single_mlp_at_output": True,
                   "quaternion_normalization": "global"},
}
WIDTH = 64


def config(head):
    return default_config({"resnet_outputs": 64, "layers": [1, 1, 1, 1],
                           "factor_fewer_resnet_channels": 8, "compute_dtype": "float32",
                           **HEADS[head]})


def jax_kwargs(cfg):
    return dict(blocks_per_stage=tuple(cfg["layers"]),
                use_single_mlp=cfg["use_single_mlp_at_output"])


def jax_model(cfg):
    return JaxOdometryModel(JaxModelConfig(
        compute_dtype=jnp.float32, resnet_outputs=cfg["resnet_outputs"],
        blocks_per_stage=tuple(cfg["layers"]),
        channel_divisor=cfg["factor_fewer_resnet_channels"], activation=cfg["activation_fct"],
        use_single_mlp=cfg["use_single_mlp_at_output"],
        quaternion_normalization=cfg["quaternion_normalization"]))


def port_model(cfg, seed=0):
    return OdometryModel(ModelConfig.from_config(cfg), torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("head", sorted(HEADS))
def test_jax_written_file_serves_in_the_port(tmp_path, head):
    cfg = config(head)
    jmodel = jax_model(cfg)
    params = random_flax_params(jmodel, WIDTH, seed=4)
    path = str(tmp_path / "model.pth")
    jax_torch_import.save_reference_checkpoint(path, params, config=cfg, epoch=7, loss=0.125,
                                               **jax_kwargs(cfg))
    state_dict = load_reference_checkpoint(path)
    want = params_from_jax(params)
    assert set(state_dict) == set(want)
    for name, value in want.items():
        assert torch.equal(state_dict[name], value), name

    model = port_model(cfg)
    model.load_state_dict(state_dict, strict=True)
    im1, im2 = make_images(WIDTH, seed=9)
    t_ref, q_ref = jax.jit(jmodel.apply)(params, jnp.asarray(im1), jnp.asarray(im2))
    with torch.no_grad():
        t_out, q_out = model(torch.from_numpy(im1), torch.from_numpy(im2))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(t_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(q_out.numpy(), np.asarray(q_ref), rtol=1e-4, atol=1e-5)

    # Served from the file: the same poses as serving the weights directly.
    small = default_config({"kitti": {"vertical_cells": 16, "horizontal_cells": WIDTH}},
                           base=cfg)
    rng = np.random.default_rng(1)
    scans = [rng.normal(size=(2000, 3)).astype(np.float32) * 10.0 for _ in range(3)]
    served = [StreamingOdometry(small, params=p, device="cpu")
              for p in (load_reference_checkpoint(path), want)]
    for scan in scans:
        outs = [engine.push_scan(scan) for engine in served]
    assert np.array_equal(outs[0][0], outs[1][0]) and np.isfinite(outs[0][0]).all()


@pytest.mark.parametrize("head", sorted(HEADS))
def test_port_written_file_loads_in_jax(tmp_path, head):
    cfg = config(head)
    state_dict = port_model(cfg, seed=2).state_dict()
    path = str(tmp_path / "model.pth")
    save_reference_checkpoint(path, state_dict, cfg, epoch=5, loss=0.5)
    params = jax_torch_import.load_reference_checkpoint(path, **jax_kwargs(cfg))
    want = params_to_jax(state_dict)
    got = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got) == len(leaves)
    for key, leaf in leaves:
        np.testing.assert_array_equal(got[key], leaf)
    payload = torch.load(path, map_location="cpu", weights_only=False)
    assert set(payload) == {"epoch", "model_state_dict", "optimizer_state_dict", "loss",
                            "parameters"}
    assert (payload["epoch"], payload["loss"], payload["parameters"]) == (5, 0.5, cfg)


def test_missing_renamed_or_misshapen_weights_raise(tmp_path):
    cfg = config("two_mlps")
    state_dict = port_model(cfg).state_dict()
    missing = {k: v for k, v in state_dict.items() if k != "resnet.fc.bias"}
    with pytest.raises(KeyError, match="resnet.fc.bias"):
        save_reference_checkpoint(str(tmp_path / "a.pth"), missing, cfg)

    renamed = {k.replace("fully_connected_rotation.3", "fully_connected_rotation.2"): v
               for k, v in state_dict.items()}
    path = str(tmp_path / "b.pth")
    torch.save({"model_state_dict": renamed, "parameters": cfg}, path)
    with pytest.raises(KeyError, match="fully_connected_rotation.2.weight"):
        load_reference_checkpoint(path)

    shapes = dict(state_dict, **{"resnet.fc.bias": torch.zeros(3)})
    torch.save({"model_state_dict": shapes, "parameters": cfg}, path)
    with pytest.raises(ValueError, match="resnet.fc.bias"):
        load_reference_checkpoint(path)
    # The layout of another config (the single head) refuses these weights.
    torch.save({"model_state_dict": state_dict}, path)
    with pytest.raises(KeyError):
        load_reference_checkpoint(path, config("single_mlp"))


@pytest.mark.parametrize("head", sorted(HEADS))
def test_export_torch_writes_the_live_weights(tmp_path, head):
    """A port trainer checkpoint with an EMA: the export holds the live
    weights (``state["model"]``), as the JAX command exports
    ``state.params``."""
    cfg = config(head)
    live = port_model(cfg, seed=1).state_dict()
    ema = port_model(cfg, seed=6).state_dict()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save({"model": live, "ema": ema, "optimizer": {}, "schedule": {}}, 4, 0.75, cfg)
    out = str(tmp_path / "export.pth")
    assert cli.main(["export-torch", "--checkpoint", ckpt.path("latest"), "--out", out]) == out

    payload = torch.load(out, map_location="cpu", weights_only=False)
    want = jax_torch_import.params_to_torch_state_dict(params_to_jax(live), **jax_kwargs(cfg))
    assert set(payload["model_state_dict"]) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(payload["model_state_dict"][name].numpy(), value)
    _, meta = ckpt.restore("latest")
    assert (payload["epoch"], payload["loss"]) == (4, 0.75)
    assert payload["parameters"] == meta["parameters"]
