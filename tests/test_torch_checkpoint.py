"""The port's checkpoints (``delora_tpu_torch/training/checkpoint.py``) and
the trainer's resume: a save and restore round trip is exact; the names and
cadence are the JAX package's ``CheckpointManager``'s; the embedded config
comes back; and on the CPU, two epochs equal one epoch, a resume from
``latest`` and one more epoch, bit for bit, with and without the parameter
EMA (and with dropout, whose generator is part of the state), under a
cosine learning-rate schedule, and with augmentation (its generator is part
of the state too).
"""

import json
import os
import types

import jax.numpy as jnp
import pytest
import torch

from delora_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from delora_tpu_torch.config import default_config
from delora_tpu_torch.training.checkpoint import CheckpointManager, deploy_weights
from delora_tpu_torch.training.trainer import Trainer
from tests.test_torch_dataset import dataset_overrides, write_preprocessed

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)

RECIPE = {"ema_decay": 0.9, "use_dropout": True, "soft_match_sigma": 0.3,
          "lambda_reverse_po2pl": 1.0}
COSINE = {"lr_schedule": "cosine", "lr_decay_steps": 5, "lr_min_ratio": 0.1}
AUGMENT = {"random_point_cloud_rotations": True}
AUGMENT_CACHED = {"random_point_cloud_rotations": True, "cache_source_projections": False}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    write_preprocessed(str(root))
    return root


def config(root, name, **extra):
    return default_config(dataset_overrides(root, checkpoint_dir=str(root / name), **extra))


def assert_same(a, b, path="state"):
    if torch.is_tensor(a):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("extra", [{}, RECIPE], ids=["plain", "recipe"])
def test_round_trip_is_exact(root, extra):
    trainer = Trainer(config(root, "rt", **extra), device="cpu")
    trainer.train(1)
    state = trainer.state_dict()
    restored, meta = trainer.ckpt.restore("latest")
    assert_same(state, restored)
    assert meta["epoch"] == 0 and meta["parameters"]["batch_size"] == 2
    assert ("ema" in restored) == ("ema_decay" in extra)
    other = Trainer(config(root, "rt_other", **extra), device="cpu",
                    generator=torch.Generator().manual_seed(5))
    other.load_state_dict(restored)
    assert_same(other.state_dict(), state)
    weights = deploy_weights(restored)
    assert weights is (restored["ema"] if extra else restored["model"])


def test_cadence_and_names_match_the_reference(tmp_path):
    ours = CheckpointManager(str(tmp_path / "port"), keep_every=2)
    ref = JaxCheckpointManager(str(tmp_path / "jax"), keep_every=2)
    jax_state = types.SimpleNamespace(params={"w": jnp.zeros(3)}, opt_state={"m": jnp.ones(3)},
                                      step=0)
    cfg = {"batch_size": 2, "kitti": {"max_points": 64}}
    for epoch in range(5):
        ours.save({"model": {"w": torch.zeros(3)}}, epoch, 0.5 + epoch, cfg)
        ref.save(jax_state, epoch, 0.5 + epoch, cfg)
    ours.save_named({"model": {"w": torch.ones(3)}}, "best", 3, 0.25, cfg, {"eval_score": 0.25})
    ref.save_named(jax_state, "best", 3, 0.25, cfg, extra_meta={"eval_score": 0.25})
    ref_names = sorted(n[:-len("_meta.json")] if n.endswith("_meta.json") else n
                       for n in os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(set(ref_names)) == [
        "best", "epoch_00000", "epoch_00002", "epoch_00004", "latest"]
    for name in ("latest", "epoch_00002", "best"):
        _, meta = ours.restore(name)
        with open(tmp_path / "jax" / f"{name}_meta.json") as f:
            assert meta == json.load(f)
    assert ours.restore("best")[0]["model"]["w"].tolist() == [1.0, 1.0, 1.0]


def test_embedded_config(root):
    cfg = config(root, "embedded")
    trainer = Trainer(cfg, device="cpu")
    trainer.train(1)
    directory = str(root / "embedded")
    embedded = CheckpointManager.embedded_config(os.path.join(directory, "latest"))
    assert embedded == json.loads(json.dumps(cfg))
    assert default_config(base=embedded) == cfg
    # A name without a file falls back to 'latest' beside it, as the
    # reference falls back to latest_meta.json.
    assert CheckpointManager.embedded_config(os.path.join(directory, "missing")) == embedded
    assert CheckpointManager.embedded_config(str(root / "nowhere" / "latest")) is None


@pytest.mark.parametrize("tag,extra", [("plain", {}), ("recipe", RECIPE), ("cosine", COSINE),
                                       ("augment", AUGMENT),
                                       ("augment_cached", AUGMENT_CACHED)],
                         ids=["plain", "recipe", "cosine", "augment", "augment_cached"])
def test_resume_equals_an_uninterrupted_run(root, tag, extra):
    """The recipe carries the EMA and the dropout generator, the cosine
    schedule its step count, augmentation its generator (on the fully-cached
    and the cached-target feed)."""
    straight = Trainer(config(root, f"straight_{tag}", **extra), device="cpu")
    full = straight.train(2)

    first = Trainer(config(root, f"split_{tag}", **extra), device="cpu")
    first.train(1)
    resumed = Trainer(config(root, f"split_{tag}", checkpoint="latest", **extra), device="cpu")
    assert resumed.start_epoch == 1 and not resumed.supervised
    second = resumed.train(2)
    assert len(second) == 1
    for key, value in full[1].items():
        if key not in ("epoch_seconds", "scan_pairs_per_sec"):
            assert second[0][key] == value, key
    assert_same(resumed.state_dict(), straight.state_dict())


def test_auto_resume_finds_latest(root):
    Trainer(config(root, "auto"), device="cpu").train(1)
    trainer = Trainer(config(root, "auto", auto_resume=True), device="cpu")
    assert trainer.start_epoch == 1 and not trainer.supervised
    fresh = Trainer(config(root, "auto_empty", auto_resume=True), device="cpu")
    assert fresh.start_epoch == 0


def test_save_cadence_of_the_trainer(root):
    trainer = Trainer(config(root, "cadence", checkpoint_every_epochs=2,
                             checkpoint_keep_every=3), device="cpu")
    saved = []
    trainer.ckpt.save = lambda state, epoch, loss, cfg: saved.append(epoch)
    trainer.train(6)
    # epoch % every == 0, and the last epoch.
    assert saved == [0, 2, 4, 5]
