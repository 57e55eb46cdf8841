"""The port's streaming odometry against the JAX engine, on the CPU.

Both engines get the same Flax params (the port through ``params_from_jax``)
and the same 4 numpy-seeded scans; relative and accumulated poses agree to
1e-5 in float32.
"""

import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from delora_tpu.config import load_config
from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu.serving import stream as jstream
from delora_tpu.training.state import TrainState
from delora_tpu_torch.config import default_config
from delora_tpu_torch.serving import stream as tstream
from delora_tpu_torch.training.checkpoint import CheckpointManager
from delora_tpu_torch.utils.params import params_from_jax

OVERRIDES = {
    "kitti": {"max_points": 4096, "vertical_cells": 16, "horizontal_cells": 64},
    "resnet_outputs": 64, "layers": [1, 1, 1, 1],
    "factor_fewer_resnet_channels": 8, "compute_dtype": "float32",
}


def make_scans(n_scans=4, n=5000, seed=0):
    """A sensor moving 0.5 m per scan through a fixed numpy scene (ground,
    two walls, pillars); each scan also holds a few NaN and too-close points."""
    rng = np.random.default_rng(seed)
    ground = np.c_[rng.uniform(-40, 40, (6000, 2)), np.full(6000, -1.7)]
    wall_a = np.c_[rng.uniform(-40, 40, 3000), np.full(3000, 8.0), rng.uniform(-1.7, 3, 3000)]
    wall_b = np.c_[rng.uniform(-40, 40, 3000), np.full(3000, -6.0), rng.uniform(-1.7, 3, 3000)]
    theta = rng.uniform(0, 2 * math.pi, 2000)
    pillars = np.c_[10 + 0.5 * np.cos(theta), 3 + 0.5 * np.sin(theta), rng.uniform(-1.7, 3, 2000)]
    world = np.concatenate([ground, wall_a, wall_b, pillars])
    scans = []
    for k in range(n_scans):
        yaw = 0.02 * k
        R = np.array([[math.cos(yaw), -math.sin(yaw), 0], [math.sin(yaw), math.cos(yaw), 0],
                      [0, 0, 1]])
        local = (world - np.array([0.5 * k, 0.0, 0.0])) @ R
        pts = local[rng.choice(len(local), n, replace=False)].astype(np.float32)
        pts[:5] = np.nan
        pts[5:10] = 0.1
        scans.append(np.c_[pts, rng.random(n).astype(np.float32)])  # + intensity
    return scans


def random_flax_params(model, height, width, seed=0):
    x = jnp.zeros((1, height, width, 4), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.fixture(scope="module")
def engines():
    jconfig = load_config(OVERRIDES, mode="testing")
    jmodel = JaxOdometryModel(JaxModelConfig.from_config(jconfig))
    params = random_flax_params(jmodel, 16, 64)
    state = TrainState.create(apply_fn=jmodel.apply, params=params, tx=optax.identity())
    jeng = jstream.StreamingOdometry(jconfig, state=state)
    teng = tstream.StreamingOdometry(default_config(OVERRIDES),
                                     params=params_from_jax(params), device="cpu")
    return jeng, teng


def test_streaming_poses_match_jax(engines):
    jeng, teng = engines
    scans = make_scans()
    assert jeng.push_scan(scans[0]) is None and teng.push_scan(scans[0]) is None
    for scan in scans[1:]:
        T_ref, pose_ref, _ = jeng.push_scan(scan)
        T, pose, latency = teng.push_scan(scan)
        assert T.dtype == np.float32 and latency > 0
        np.testing.assert_allclose(T, T_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pose, pose_ref, rtol=0, atol=1e-5)
    # The scene must give the model something to see: not the identity.
    assert np.abs(T - np.eye(4)).max() > 1e-3


def test_serve_stdin_jsonl_keys_match_jax(engines, tmp_path, monkeypatch, capsys):
    jeng, teng = engines
    paths = []
    for i, scan in enumerate(make_scans(3, seed=1)):
        path = tmp_path / f"scan{i}.npy"
        np.save(path, scan)
        paths.append(str(path))
    scan_bin = tmp_path / "scan3.bin"
    make_scans(1, seed=2)[0].tofile(scan_bin)
    paths.append(str(scan_bin))
    lines = "\n".join(json.dumps({"scan": p}) for p in paths)
    lines += "\n" + json.dumps({"scan": str(tmp_path / "missing.npy")}) + "\n"

    outputs = []
    for engine in (jeng, teng):
        engine._prev_img = None
        monkeypatch.setattr("sys.stdin", io.StringIO(lines))
        engine.serve_stdin()
        outputs.append([json.loads(line) for line in capsys.readouterr().out.splitlines()])
    ref, out = outputs
    assert len(out) == len(ref) == 6
    assert [sorted(m) for m in out] == [sorted(m) for m in ref]
    assert out[0] == {"ready": True, "dataset": "kitti"} and out[1] == {"first_scan": True}
    assert "error" in out[5]
    np.testing.assert_allclose(out[2]["relative"], ref[2]["relative"], rtol=0, atol=1e-5)


def test_filter_scan_and_integrator_match_jax():
    scan = make_scans(1, seed=3)[0]
    np.testing.assert_array_equal(tstream.filter_scan(scan), jstream.filter_scan(scan))
    rng = np.random.default_rng(4)
    ti, ji = tstream.OdometryIntegrator(), jstream.OdometryIntegrator()
    for _ in range(5):
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(T[:3, :3]) < 0:
            T[:3, 2] *= -1
        T[:3, 3] = rng.normal(size=3)
        np.testing.assert_allclose(ti.integrate(T), ji.integrate(T), rtol=0, atol=1e-12)


def write_checkpoint(directory, config, model) -> str:
    """A trainer checkpoint (``CheckpointManager``) of ``model`` -> its path."""
    CheckpointManager(str(directory)).save({"model": model.state_dict()}, 0, 0.0, config)
    return str(directory / "latest")


def test_checkpoint_round_trip(tmp_path):
    config = default_config(OVERRIDES)
    eng = tstream.StreamingOdometry(config, device="cpu")
    path = write_checkpoint(tmp_path, config, eng.model)
    embedded, _ = tstream.load_serving_checkpoint(path)
    assert embedded == json.loads(json.dumps(config))
    eng2 = tstream.StreamingOdometry(embedded, checkpoint=path, device="cpu")
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, eng2.model.state_dict()[k])


def test_serving_checkpoint_of_the_older_layout(tmp_path):
    """A ``{"config", "model"}`` file, as the serving slice wrote them, still
    serves its weights under its config."""
    config = default_config(OVERRIDES)
    eng = tstream.StreamingOdometry(config, device="cpu")
    path = str(tmp_path / "ckpt.pt")
    torch.save({"config": config, "model": eng.model.state_dict()}, path)
    embedded, weights = tstream.load_serving_checkpoint(path)
    assert embedded == config
    eng2 = tstream.StreamingOdometry(embedded, checkpoint=path, device="cpu")
    for k, v in eng.model.state_dict().items():
        assert torch.equal(v, weights[k]) and torch.equal(v, eng2.model.state_dict()[k])


def test_cli_serve_from_checkpoint(tmp_path, monkeypatch, capsys):
    """``python -m delora_tpu_torch.cli serve``: the checkpoint's embedded
    config is the base, ``--set`` overrides it, JSONL in and out."""
    from delora_tpu_torch import cli

    config = default_config(OVERRIDES)
    engine = tstream.StreamingOdometry(config, device="cpu")
    ckpt = write_checkpoint(tmp_path, config, engine.model)
    paths = []
    for i, scan in enumerate(make_scans(2, seed=5)):
        paths.append(str(tmp_path / f"s{i}.npy"))
        np.save(paths[-1], scan)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps({"scan": p}) + "\n" for p in paths)))
    cli.main(["serve", "--checkpoint", ckpt, "--device", "cpu",
              "--set", "quaternion_normalization=global"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0]["ready"] and lines[1] == {"first_scan": True}
    # Global quaternion normalization decodes to the same rotation.
    scans = make_scans(2, seed=5)
    engine.push_scan(scans[0])
    T = engine.push_scan(scans[1])[0]
    np.testing.assert_allclose(lines[2]["relative"], T, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fov", [
    {"horizontal_field_of_view": [-90.0, 90.0]},
    {"kitti": {"vertical_field_of_view": [-20.0, 5.0]}},
])
def test_cli_fov_override_over_checkpoint(tmp_path, fov):
    """A field of view given with ``--set`` is in degrees also when a
    checkpoint's embedded config (in radians) is the base."""
    from delora_tpu_torch import cli

    config = default_config(OVERRIDES)
    ckpt = write_checkpoint(tmp_path, config,
                            tstream.StreamingOdometry(config, device="cpu").model)
    served = cli.serve_config(ckpt, cli._parse_overrides(
        [f"{key}={json.dumps(value)}" for key, value in fov.items()]))
    merged = {**OVERRIDES, **fov, "kitti": {**OVERRIDES["kitti"], **fov.get("kitti", {})}}
    assert served == default_config(merged)
    ref = load_config(merged, mode="testing")
    assert served["horizontal_field_of_view"] == ref["horizontal_field_of_view"]
    assert served["kitti"]["vertical_field_of_view"] == ref["kitti"]["vertical_field_of_view"]
