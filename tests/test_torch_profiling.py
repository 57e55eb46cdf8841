"""``profile_epochs`` on ``torch.profiler`` (``delora_tpu_torch/utils/
profiling.py``): the listed epochs, and only they, are traced into the run's
``profile`` artifact directory as Chrome traces whose events name the step's
regions (``batch``, ``train_step``) and the step's operations; the traced
epoch trains as an untraced one does."""

import json
import os

import numpy as np
import torch

from delora_tpu_torch.config import default_config
from delora_tpu_torch.training.trainer import Trainer
from delora_tpu_torch.utils.profiling import annotate, trace
from tests.test_torch_trainer import SMALL, tiny_world

torch.set_num_threads(1)


def event_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_names_its_regions(tmp_path):
    with trace(str(tmp_path / "p"), "region"):
        with annotate("outer"):
            torch.ones(4).add_(1.0)
    names = event_names(tmp_path / "p" / "region.pt.trace.json")
    assert "outer" in names and any("add_" in str(n) for n in names)


def test_profile_epochs_trace_the_step_regions(tmp_path):
    config = default_config({**SMALL, "profile_epochs": [1], "log_dir": str(tmp_path / "runs"),
                             "experiment": "exp"})
    world = tiny_world([4])
    traced = Trainer(config, world, device="cpu", run_name="prof",
                     generator=torch.Generator().manual_seed(0))
    history = traced.train(2)
    profile = tmp_path / "runs" / "exp" / "prof" / "artifacts" / "profile"
    assert sorted(os.listdir(profile)) == ["epoch_00001.pt.trace.json"]
    names = event_names(profile / "epoch_00001.pt.trace.json")
    assert {"batch", "train_step"} <= names
    assert any("convolution" in str(n) for n in names)

    plain = Trainer(dict(config, profile_epochs=[]), world, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    for a, b in zip(history, plain.train(2)):
        assert all(a[k] == b[k] for k in a if k not in ("epoch_seconds", "scan_pairs_per_sec"))
    assert np.isfinite(history[1]["loss"])
