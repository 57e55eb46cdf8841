"""The port's trainer fed from disk against the JAX package's ``Trainer`` on
one synthetic world: the same preprocessed files, fp32, the same starting
parameters (``utils/params.py::params_from_jax``), three unsupervised epochs
of the fully-cached feed with device-resident tables, and of the
cached-target feed (streamed); and projective matching on that feed, step by
step at the JAX trainer's weights.

Tolerance: each epoch's mean losses and metrics within rtol 1e-4 (atol 1e-6).
One step of the two agrees within float32 rounding (``tests/test_torch_step.
py``); three epochs of Adam at lr 1e-4 carry those differences into the
weights, and the means move by a few ulps a step.

Also, on the port alone: two datasets train in turn, each with its own pairs
and epoch order.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from delora_tpu.config import load_config
from delora_tpu.training.trainer import Trainer as JaxTrainer
from delora_tpu_torch.config import default_config
from delora_tpu_torch.training.trainer import Trainer
from delora_tpu_torch.utils.params import params_from_jax
from tests.test_torch_dataset import dataset_overrides, write_preprocessed

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)

EPOCHS = 3
KEYS = ("loss", "loss_pc", "loss_po2pl", "loss_pl2pl", "loss_identity", "num_po2pl_pairs",
        "visible_pixels", "grad_norm")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_disk")
    write_preprocessed(str(root))
    return root


def track_the_jax_trainer(root, name, **extra):
    ref = JaxTrainer(load_config(dataset_overrides(
        root, checkpoint_dir=str(root / f"jax_ckpt_{name}"),
        log_dir=str(root / f"jax_runs_{name}"), **extra)), run_name="jax")
    params = jax.tree.map(np.asarray, ref.state.params)
    port = Trainer(default_config(dataset_overrides(
        root, checkpoint_dir=str(root / f"ckpt_{name}"), **extra)), device="cpu",
        run_name="port")
    port.model.load_state_dict(params_from_jax(params))
    assert not ref.supervised and not port.supervised
    assert port.feed == ref.feed
    for epoch in range(EPOCHS):
        want = ref.train_epoch(epoch)
        got = port.train_epoch(epoch)
        assert got["steps"] == want["steps"] == 3
        for key in KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                       err_msg=f"epoch {epoch} {key}")
    return port


def test_three_epochs_track_the_jax_trainer(root):
    track_the_jax_trainer(root, "full")


def test_three_epochs_of_the_cached_feed_track_the_jax_trainer(root):
    """The cached-target feed (target artifacts, raw source), augmentation
    off: the two packages' random draws cannot match."""
    port = track_the_jax_trainer(root, "cached", cache_source_projections=False)
    assert port.feed == "cached" and port.feeds["kitti"].loader is not None


def test_cached_projective_steps_at_the_jax_trainers_weights(root):
    """Projective matching on the cached-target feed: at the JAX trainer's
    weights before each of three epochs, the port's loss and metrics of
    every batch of the epoch agree within rtol 1e-5. (Three epochs trained by
    each package apart drift further than the image matcher's rtol 1e-4:
    Adam turns last-bit gradient differences into visible shares of lr
    (``tests/test_torch_step.py``), and a bfloat16-ranked winner moves
    with them.)"""
    from delora_tpu.training import step as jstep
    from delora_tpu_torch.training import step as tstep

    extra = dict(cache_source_projections=False, correspondence="projective")
    ref = JaxTrainer(load_config(dataset_overrides(
        root, checkpoint_dir=str(root / "jax_ckpt_proj"), log_dir=str(root / "jax_runs_proj"),
        **extra)), run_name="jax")
    port = Trainer(default_config(dataset_overrides(
        root, checkpoint_dir=str(root / "ckpt_proj"), **extra)), device="cpu", run_name="port")
    ds = port.feeds["kitti"].loader.dataset
    jcfg = jstep.StepConfig.from_config(ref.config, "kitti", supervised=False)
    cfg = tstep.StepConfig.from_config(port.config, supervised=False)
    losses = jax.jit(lambda p, b: jstep.loss_and_metrics_cached(
        ref.state.apply_fn, p, b, jcfg, jax.random.PRNGKey(0))[1][0])
    for epoch in range(EPOCHS):
        port.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, ref.state.params)))
        for sel in port.epoch_indices(epoch).reshape(-1, port.batch_size):
            batch = ds.make_cached_batch(sel)
            want = losses(ref.state.params, jstep.CachedTargetBatch(*batch))
            with torch.no_grad():
                _, got = tstep.loss_and_metrics_cached(
                    port.model, tstep.CachedTargetBatch(*map(torch.from_numpy, batch)), cfg)
            assert float(want["num_po2pl_pairs"]) > 100
            for key in KEYS[:-1]:
                np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5,
                                           err_msg=f"epoch {epoch} {key}")
        ref.train_epoch(epoch)


def test_datasets_train_in_turn(root, tmp_path):
    second = tmp_path / "second"
    shutil.copytree(root / "preprocessed" / "01", second / "00")
    cfg = dataset_overrides(root, datasets=["kitti", "other"])
    other = dict(cfg["kitti"], preprocessed_path=str(second), training_identifiers=[0],
                 vertical_field_of_view=[-24.5, 2.0])
    trainer = Trainer(default_config({**cfg, "other": other}), device="cpu")
    assert trainer.datasets == ["kitti", "other"]
    assert trainer.feeds["kitti"].num_pairs == 7 and trainer.feeds["other"].num_pairs == 3
    np.testing.assert_array_equal(trainer.epoch_indices(2, "other"),
                                  np.random.default_rng(2).permutation(3)[:2])
    seen = []
    step = trainer.step
    trainer.step = lambda batch, cfg: seen.append(batch.image_1.shape) or step(batch, cfg)
    metrics = trainer.train_epoch(0)
    assert metrics["steps"] == 3 + 1 and len(seen) == 4
    assert os.path.isdir(trainer.logger.run_dir)
    assert torch.isfinite(torch.tensor(metrics["loss"]))


def test_raw_feed_streams_from_disk(root):
    """Brute correspondence reads padded clouds: batches stream from the
    host (no tables), each step finite, in the loader's order."""
    trainer = Trainer(default_config(dataset_overrides(root, correspondence="brute")),
                      device="cpu")
    assert trainer.feed == "raw" and trainer.feeds["kitti"].tables is None
    loader = trainer.feeds["kitti"].loader
    np.testing.assert_array_equal(trainer.epoch_indices(1), loader.global_epoch_indices(1))
    history = trainer.train(2)
    assert [h["steps"] for h in history] == [3, 3]
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert history[1]["num_po2pl_pairs"] > 10
