"""The port's trainer on the CPU: a tiny world of in-memory scans, tables on
the device (here the CPU), the warmup switch, the epoch order of the
reference's loader, and pairs that never cross sequences."""

import math

import numpy as np
import pytest
import torch

from delora_tpu_torch.config import default_config
from delora_tpu_torch.training.trainer import Trainer

SMALL = {"kitti": {"max_points": 1024, "vertical_cells": 8, "horizontal_cells": 32},
         "resnet_outputs": 8, "layers": [1, 1, 1, 1], "factor_fewer_resnet_channels": 16,
         "compute_dtype": "float32", "batch_size": 1, "learning_rate": 0.01}


def tiny_world(lengths, seed=0, n=600):
    """Sequences of random scans over the sensor's field of view, with unit
    normals (a fifth of them zero: no normal)."""
    rng = np.random.default_rng(seed)

    def scan():
        az = rng.uniform(-math.pi, math.pi, n)
        el = rng.uniform(-0.4, 0.03, n)
        r = rng.uniform(2.0, 30.0, n)
        pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                        r * np.sin(el)], -1).astype(np.float32)
        nrm = rng.normal(size=(n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm[rng.random(n) < 0.2] = 0.0
        return pts, nrm

    return [[scan() for _ in range(k)] for k in lengths]


def test_trainer_leaves_warmup_and_trains_unsupervised():
    trainer = Trainer(default_config(SMALL), tiny_world([10, 4]), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    history = trainer.train(3)
    assert [h["supervised"] for h in history] == [1.0, 1.0, 0.0]
    assert history[1]["loss"] < 1e-2 < history[0]["loss"]
    # Unsupervised, the loss is the ICP loss.
    assert history[2]["loss"] == pytest.approx(history[2]["loss_pc"])
    for h in history:
        assert h["steps"] == 12 and h["placement_overflow_tiles"] == 0.0
        assert all(np.isfinite(v) for v in h.values())
        assert h["num_po2pl_pairs"] > 10


def test_pairs_stay_inside_sequences_and_epochs_follow_the_loader():
    config = default_config({**SMALL, "batch_size": 4, "unsupervised_at_start": True})
    trainer = Trainer(config, tiny_world([5, 3, 4]), device="cpu")
    assert not trainer.supervised
    # Scans 0-4, 5-7, 8-11: no pair (4, 5) or (7, 8).
    assert trainer.pair_target.tolist() == [0, 1, 2, 3, 5, 6, 8, 9, 10]
    assert trainer.pair_source.tolist() == [1, 2, 3, 4, 6, 7, 9, 10, 11]
    for epoch in (0, 3):
        expected = np.random.default_rng(epoch).permutation(9)[:8]
        np.testing.assert_array_equal(trainer.epoch_indices(epoch), expected)
    assert trainer.tables.image.shape == (12, 8, 32, 4)
    assert trainer.tables.src_points.shape == (12, 8 * 32, 3)
    assert trainer.tables.mean_range.dtype == torch.float32


def test_trainer_needs_a_whole_batch():
    with pytest.raises(ValueError):
        Trainer(default_config({**SMALL, "batch_size": 8}), tiny_world([4]), device="cpu")


def test_trainer_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(default_config(SMALL), tiny_world([3]))
