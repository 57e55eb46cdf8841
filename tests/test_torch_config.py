"""The port's config (Python data) against ``delora_tpu.config.load_config``."""

import pytest

from delora_tpu.config import load_config
from delora_tpu_torch.config import default_config


def assert_carried_equal(port, ref, path=""):
    for key, value in port.items():
        assert key in ref, f"{path}{key} not in load_config()"
        if isinstance(value, dict):
            assert_carried_equal(value, ref[key], f"{path}{key}.")
        else:
            assert value == ref[key], f"{path}{key}: {value!r} != {ref[key]!r}"
            assert type(value) is type(ref[key]), f"{path}{key}: type differs"


OVERRIDES = {
    "defaults": None,
    "small": {"kitti": {"max_points": 4096, "vertical_cells": 16, "horizontal_cells": 64},
              "resnet_outputs": 64, "layers": [1, 1, 1, 1],
              "factor_fewer_resnet_channels": 8, "compute_dtype": "float32"},
    "fov": {"horizontal_field_of_view": [-90.0, 90.0],
            "kitti": {"vertical_field_of_view": [-20.0, 5.0]},
            "activation_fct": "relu", "quaternion_normalization": "global"},
}


@pytest.mark.parametrize("name", sorted(OVERRIDES))
def test_config_matches_load_config(name):
    port = default_config(OVERRIDES[name])
    ref = load_config(OVERRIDES[name])
    assert_carried_equal(port, ref)


def test_config_carries_the_serving_keys():
    config = default_config()
    for key in ("activation_fct", "resnet_outputs", "layers", "factor_fewer_resnet_channels",
                "resnet_stage_width_multipliers", "use_single_mlp_at_output",
                "quaternion_normalization", "pre_feature_extraction", "compute_dtype",
                "horizontal_field_of_view"):
        assert key in config
    assert config["kitti"]["max_points"] == 131072
    assert (config["kitti"]["vertical_cells"], config["kitti"]["horizontal_cells"]) == (64, 720)


def test_config_rejects_bad_values():
    with pytest.raises(ValueError):
        default_config({"activation_fct": "gelu"})
    with pytest.raises(ValueError):
        default_config({"quaternion_normalization": "none"})
    with pytest.raises(ValueError):
        default_config({"native_io": "yes"})


@pytest.mark.parametrize("override", [
    {"kitti": {"dataset_type": "rosbag"}},
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()).replace(" ", ""))
def test_unported_settings_raise(override):
    """Settings whose code the port does not have are refused, never run."""
    with pytest.raises(NotImplementedError):
        default_config(override)


@pytest.mark.parametrize("override", [
    {"soft_match_sigma": 0.3},
    {"lambda_reverse_po2pl": 1.0},
    {"ema_decay": 0.999},
    {"use_dropout": True},
    {"correspondence": "brute"},
    {"cache_target_projections": False},
    {"random_point_cloud_rotations": True},
    {"correspondence": "projective"},
    {"fused_adam": True},
    {"cache_source_projections": False},
    {"remat": True},
    {"native_io": True},
    {"profile_epochs": [1]},
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_ported_settings_are_accepted_and_run(override):
    """The quality recipe's settings, brute and projective correspondence,
    augmentation, the raw and the cached-target feeds
    (``cache_source_projections: false``), ``fused_adam``, ``remat``,
    ``native_io`` and ``profile_epochs`` pass validation and train: one epoch
    of a tiny world on the CPU."""
    import numpy as np
    import torch

    from delora_tpu_torch.training.trainer import Trainer
    from tests.test_torch_trainer import SMALL, tiny_world

    config = default_config({**SMALL, **override})
    assert all(config[k] == v for k, v in override.items())
    trainer = Trainer(config, tiny_world([3]), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    metrics = trainer.train_epoch(0)
    assert metrics["steps"] == 2 and all(np.isfinite(v) for v in metrics.values())


def test_feed_follows_the_reference():
    from delora_tpu_torch.config import training_feed

    assert training_feed(default_config()) == "full"
    assert training_feed(default_config({"correspondence": "brute"})) == "raw"
    assert training_feed(default_config({"cache_target_projections": False})) == "raw"
    config = default_config({"correspondence": "brute", "cache_source_projections": False})
    assert training_feed(config) == "raw"
    assert training_feed(default_config({"cache_source_projections": False})) == "cached"
    config = default_config({"correspondence": "projective", "cache_source_projections": False})
    assert training_feed(config) == "cached"
    assert training_feed(default_config({"correspondence": "projective"})) == "full"


def test_config_carries_the_training_keys():
    config = default_config()
    for key in ("batch_size", "learning_rate", "lr_schedule", "lr_scaling",
                "lr_scaling_base_batch", "epochs", "point_to_point_loss", "point_to_plane_loss",
                "plane_to_plane_loss", "po2po_alone", "normal_loss", "lambda_po2pl",
                "lambda_pl2pl", "po2pl_trim_distance", "correspondence", "projective_window",
                "normalization_scaling", "unsupervised_at_start", "steps_per_dispatch",
                "soft_match_sigma", "lambda_reverse_po2pl", "ema_decay", "use_dropout",
                "cache_target_projections", "cache_source_projections", "use_pallas_nn"):
        assert key in config
    assert config["correspondence"] == "image" and config["projective_window"] == [5, 9]


def test_config_rejects_bad_training_values():
    with pytest.raises(ValueError):
        default_config({"normal_loss": "cubic"})
    with pytest.raises(ValueError):
        default_config({"lr_schedule": "linear"})
    with pytest.raises(ValueError):
        default_config({"projective_window": [4, 9]})
    with pytest.raises(ValueError):
        default_config({"ema_decay": 1.0})
    with pytest.raises(ValueError):
        default_config({"soft_match_sigma": -0.1})
    with pytest.raises(ValueError):
        default_config({"correspondence": "kdtree"})
