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
