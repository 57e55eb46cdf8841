"""The port's command line (``delora_tpu_torch/cli.py``): ``preprocess`` ->
``train`` -> ``test`` in-process on the CPU; the mode mapping and the
checkpoint rehydration against ``delora_tpu.cli._build_config``; ``serve
--checkpoint`` on a trainer's checkpoint."""

import io
import json
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
    assert "plotting skipped" in capsys.readouterr().out


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
