"""The port's command line (``delora_tpu_torch/cli.py``): ``preprocess`` ->
``train`` -> ``test`` in-process on the CPU; the mode mapping and the
checkpoint rehydration against ``delora_tpu.cli._build_config``; ``serve
--checkpoint`` on a trainer's checkpoint."""

import io
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from delora_tpu import cli as jax_cli
from delora_tpu_torch import cli
from delora_tpu_torch.config import default_config
from delora_tpu_torch.serving.stream import StreamingOdometry
from delora_tpu_torch.training.checkpoint import CheckpointManager, deploy_weights
from delora_tpu_torch.utils.poses import check_validity_so3, read_poses_from_text_file
from tests.test_torch_config import assert_carried_equal
from tests.test_torch_preprocess import N_SCANS, overrides, write_drive

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)


def flags(root, **extra):
    """``--set`` flags of the pipeline tests' overrides."""
    return ["--device", "cpu", "--set"] + [
        f"{k}={json.dumps(v)}" for k, v in overrides(root, **extra).items()]


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_drive(str(root))
    pre = cli.main(["preprocess"] + flags(root))
    trainer = cli.main(["train", "--epochs", "3", "--run-name", "cli"] + flags(
        root, eval_every_epochs=1, checkpoint_keep_every=2, ema_decay=0.9))
    return root, pre, trainer


def test_preprocess_train_test(pipeline, capsys):
    root, pre, trainer = pipeline
    for kind in ("scans", "normals"):
        assert len(os.listdir(root / "preprocessed" / "00" / kind)) == N_SCANS
    assert pre.device.type == "cpu"
    assert sorted(os.listdir(root / "ckpt")) == ["best", "epoch_00000", "epoch_00002",
                                                 "latest"]
    records = [json.loads(line) for line in
               open(os.path.join(trainer.logger.run_dir, "metrics.jsonl"))]
    epochs = [r for r in records if "loss" in r]
    assert [r["step"] for r in epochs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in epochs)
    assert sum("eval_score" in r for r in records) == 3
    _, meta = trainer.ckpt.restore("best")
    assert meta["eval_score"] == trainer.best_eval[0]

    results = cli.main(["test", "--checkpoint", str(root / "ckpt" / "best"),
                        "--run-name", "cli_test", "--device", "cpu"])
    rpe = results["kitti"][0]
    assert len(rpe) == 2 and np.isfinite(rpe).all()
    config = default_config(overrides(root))
    poses = read_poses_from_text_file(os.path.join(
        config["log_dir"], config["experiment"], "cli_test", "artifacts", "poses_kitti_00.txt"))
    assert poses.shape == (N_SCANS, 4, 4)
    assert all(check_validity_so3(p[:3, :3], atol=1e-4) for p in poses)
    # The trajectory plots of the sequence (matplotlib is installed here).
    artifacts = os.path.join(config["log_dir"], config["experiment"], "cli_test", "artifacts")
    for name in ("map_kitti_00_2d.png", "map_kitti_00_y.png", "map_kitti_00_3d.png",
                 "trans_rot_kitti_00.png"):
        assert os.path.getsize(os.path.join(artifacts, name)) > 0, name
    assert "plotting skipped" not in capsys.readouterr().out


def test_resume_through_the_cli(pipeline):
    root, _, _ = pipeline
    trainer = cli.main(["train", "--epochs", "4", "--run-name", "cli_resume",
                        "--checkpoint", str(root / "ckpt" / "latest")] + flags(root))
    assert trainer.start_epoch == 3 and not trainer.supervised
    # The embedded config is the base: the first run's EMA comes back.
    assert trainer.config["ema_decay"] == 0.9 and trainer.ema is not None


@pytest.mark.parametrize("mode", ["training", "testing", "preprocessing"])
def test_mode_mapping_matches_the_reference(tmp_path, mode):
    sets = flags(tmp_path, kitti={"training_identifiers": [0, 2, 5],
                                  "testing_identifiers": [5, 9]})[3:]
    port = cli._build_config(types.SimpleNamespace(overrides=sets, checkpoint=None), mode)
    ref = jax_cli._build_config(types.SimpleNamespace(config=None, overrides=sets,
                                                      checkpoint=None), mode)
    assert_carried_equal(port, ref)
    assert port["kitti"]["data_identifiers"] == {
        "training": [0, 2, 5], "testing": [5, 9], "preprocessing": [0, 2, 5, 9]}[mode]


def test_checkpoint_rehydration_matches_the_reference(pipeline, tmp_path):
    """The embedded config, re-overridden by top-level ``--set`` values and
    the mode, as the reference's; the reference reads the same embedded
    config from ``<checkpoint>_meta.json``."""
    root, _, _ = pipeline
    checkpoint = str(root / "ckpt" / "latest")
    embedded = CheckpointManager.embedded_config(checkpoint)
    with open(tmp_path / "latest_meta.json", "w") as f:
        json.dump({"parameters": embedded}, f)
    sets = ["batch_size=4", "eval_every_epochs=0"]
    port = cli._build_config(types.SimpleNamespace(overrides=sets, checkpoint=checkpoint),
                             "testing")
    ref = jax_cli._build_config(types.SimpleNamespace(
        config=None, overrides=sets, checkpoint=str(tmp_path / "latest")), "testing")
    assert_carried_equal({k: v for k, v in port.items() if k != "checkpoint"}, ref)
    assert port["checkpoint"] == checkpoint and port["batch_size"] == 4
    assert port["ema_decay"] == 0.9 and port["kitti"]["data_identifiers"] == [0]


def test_nested_override_over_a_checkpoint_keeps_radians(pipeline, tmp_path):
    """A dataset block given with ``--set`` over a rehydrated config is
    deep-merged: the embedded vertical field of view stays in radians. (The
    reference updates the embedded config shallowly, so the block replaces
    the embedded one and its field of view comes back from the YAML in
    degrees while the config says radians.)"""
    root, _, _ = pipeline
    checkpoint = str(root / "ckpt" / "latest")
    embedded = CheckpointManager.embedded_config(checkpoint)
    sets = ['kitti={"max_points": 2048}']
    port = cli._build_config(types.SimpleNamespace(overrides=sets, checkpoint=checkpoint),
                             "testing")
    assert port["kitti"]["max_points"] == 2048
    assert port["kitti"]["vertical_field_of_view"] == embedded["kitti"]["vertical_field_of_view"]
    assert port["kitti"]["preprocessed_path"] == embedded["kitti"]["preprocessed_path"]
    with open(tmp_path / "latest_meta.json", "w") as f:
        json.dump({"parameters": embedded}, f)
    ref = jax_cli._build_config(types.SimpleNamespace(
        config=None, overrides=sets, checkpoint=str(tmp_path / "latest")), "testing")
    assert ref["kitti"]["vertical_field_of_view"] == [-24.5, 2.0]


def test_serve_reads_a_trainer_checkpoint(pipeline, monkeypatch, capsys):
    """``serve --checkpoint`` on the trainer's ``best``: its embedded config,
    and the EMA weights the run tracked."""
    root, _, _ = pipeline
    checkpoint = str(root / "ckpt" / "best")
    state, meta = CheckpointManager(str(root / "ckpt")).restore("best")
    assert "ema" in state
    scans = [np.fromfile(str(root / "raw" / "00" / "velodyne" / f"{k:06d}.bin"),
                         np.float32).reshape(-1, 4) for k in range(2)]
    paths = [str(root / "raw" / "00" / "velodyne" / f"{k:06d}.bin") for k in range(2)]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps({"scan": p}) + "\n" for p in paths)))
    cli.main(["serve", "--checkpoint", checkpoint, "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0]["ready"] and lines[1] == {"first_scan": True}
    engine = StreamingOdometry(default_config(base=meta["parameters"]),
                               params=deploy_weights(state), device="cpu")
    assert engine.config["kitti"]["horizontal_cells"] == 64
    engine.push_scan(scans[0])
    T = engine.push_scan(scans[1])[0]
    np.testing.assert_allclose(lines[2]["relative"], T, rtol=0, atol=1e-5)
    live = StreamingOdometry(default_config(base=meta["parameters"]), params=state["model"],
                             device="cpu")
    assert not all(torch.equal(a, b) for a, b in zip(live.model.state_dict().values(),
                                                     engine.model.state_dict().values()))


def test_commands_run_on_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for command in ("preprocess", "train"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([command] + flags(tmp_path)[2:])


PACKAGED = ("datasets.yaml", "deployment.yaml", "hyperparameters.yaml",
            "presets/pod_large_batch.yaml")


@pytest.fixture(scope="module")
def config_files(tmp_path_factory):
    """The JAX package's packaged YAML stack and its preset, each as YAML and
    converted to JSON (``write_config_file``: floats with a dot, so YAML 1.1
    reads the JSON the same) -> (yaml paths, json paths) by name."""
    import yaml

    from delora_tpu import config as jax_config
    from delora_tpu_torch.config import write_config_file

    root = tmp_path_factory.mktemp("configs")
    yamls, jsons = {}, {}
    for name in PACKAGED:
        yamls[name] = os.path.join(os.path.dirname(jax_config.__file__), "configs", name)
        with open(yamls[name]) as f:
            data = yaml.safe_load(f)
        jsons[name] = str(root / (os.path.basename(name)[:-5] + ".json"))
        write_config_file(jsons[name], data)
        with open(jsons[name]) as f:
            assert json.load(f) == data
    return yamls, jsons


CONFIG_SETS = ["batch_size=8", 'kitti={"max_points": 4096, "vertical_field_of_view": [-20, 3]}',
               "horizontal_field_of_view=[-90.0, 90.0]"]


@pytest.mark.parametrize("mode", ["training", "testing", "preprocessing"])
@pytest.mark.parametrize("stack", ["packaged", "packaged+preset"])
def test_config_files_match_load_config(config_files, mode, stack):
    """``--config`` JSON files equal the reference's ``load_config`` of the
    same stack (as YAML, and the same JSON files read as YAML), with ``--set``
    on top and the fields of view converted once."""
    yamls, jsons = config_files
    names = PACKAGED if stack == "packaged+preset" else PACKAGED[:3]
    args = types.SimpleNamespace(config=[jsons[n] for n in names], overrides=CONFIG_SETS,
                                 checkpoint=None)
    port = cli._build_config(args, mode)
    for files in ([yamls[n] for n in names], [jsons[n] for n in names]):
        ref = jax_cli._build_config(types.SimpleNamespace(
            config=files, overrides=CONFIG_SETS, checkpoint=None), mode)
        assert port == ref
    assert port["batch_size"] == 8 and port["kitti"]["max_points"] == 4096
    assert port["kitti"]["vertical_field_of_view"] == [-20 / 180.0 * math.pi,
                                                       3 / 180.0 * math.pi]
    assert port["darpa"]["vertical_field_of_view"] == [-22.5, 22.5]    # not in datasets
    assert port["lr_scaling"] == ("linear" if stack == "packaged+preset" else "none")


def test_config_files_replace_the_defaults_and_merge_in_order(config_files, tmp_path):
    """Later files win; the files replace the port's defaults (a stack
    without the model keys is refused, as by the reference); a file that
    sets a key the defaults lack carries it."""
    _, jsons = config_files
    extra = str(tmp_path / "extra.json")
    with open(extra, "w") as f:
        json.dump({"batch_size": 16, "kitti": {"max_points": 2048}, "profile_epochs": [2]}, f)
    stack = [jsons[n] for n in PACKAGED[:3]]
    a = default_config(files=stack + [jsons[PACKAGED[3]], extra])
    b = default_config(files=stack + [extra, jsons[PACKAGED[3]]])
    assert (a["batch_size"], b["batch_size"]) == (16, 4096)
    assert a["kitti"]["max_points"] == b["kitti"]["max_points"] == 2048
    assert a["profile_epochs"] == [2] and a["visualize_every_epochs"] == 10
    assert a["kitti"]["vertical_cells"] == 64          # deep-merged, not replaced
    with pytest.raises(KeyError):
        default_config(files=[jsons[PACKAGED[3]]])
    with pytest.raises(KeyError):
        jax_cli.load_config(config_files=[jsons[PACKAGED[3]]])


def test_config_file_from_the_port_defaults_is_the_default_config(tmp_path):
    """A file written from ``default_settings()`` (the YAML's units) gives
    the default config, in every mode."""
    from delora_tpu_torch.config import default_settings

    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(default_settings(), f)
    for mode in ("training", "testing", "preprocessing"):
        assert default_config(mode=mode, files=[path]) == default_config(mode=mode)
