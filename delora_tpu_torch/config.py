"""The settings of the ported slice, as Python data.

The same flat dict that ``delora_tpu.config.load_config()`` builds from its
YAML stack, cut to the keys the serving path reads: the KITTI sensor spec and
the model keys. Values are those of ``delora_tpu/configs/*.yaml``; fields of
view are written in degrees and converted to radians once, by the same
formula, so the floats are identical.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Mapping, Optional

_DEFAULTS: Dict[str, Any] = {
    # datasets.yaml
    "horizontal_field_of_view": [-179.9, 179.9],      # degrees
    "kitti": {
        "vertical_field_of_view": [-24.5, 2.0],       # degrees
        "vertical_cells": 64,
        "horizontal_cells": 720,
        "max_points": 131072,
    },
    # deployment.yaml
    "datasets": ["kitti"],
    "compute_dtype": "bfloat16",
    # hyperparameters.yaml
    "activation_fct": "tanh",
    "resnet_outputs": 1000,
    "pre_feature_extraction": False,
    "layers": [2, 2, 2, 2],
    "factor_fewer_resnet_channels": 1,
    "resnet_stage_width_multipliers": [1.0, 1.0, 1.0, 1.0],
    "use_single_mlp_at_output": False,
    "quaternion_normalization": "per_row",
}


def _deep_merge(base: Dict[str, Any], other: Mapping[str, Any]) -> Dict[str, Any]:
    for key, value in other.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, Mapping):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def _deg2rad_list(values):
    return [v / 180.0 * math.pi for v in values]


def _fov_to_radians(settings: Dict[str, Any]) -> Dict[str, Any]:
    """Convert the fields of view that ``settings`` holds from degrees to
    radians, in place: the horizontal one and each dataset's vertical one."""
    if "horizontal_field_of_view" in settings:
        settings["horizontal_field_of_view"] = _deg2rad_list(
            settings["horizontal_field_of_view"]
        )
    for spec in settings.values():
        if isinstance(spec, dict) and "vertical_field_of_view" in spec:
            spec["vertical_field_of_view"] = _deg2rad_list(spec["vertical_field_of_view"])
    return settings


def default_config(
    overrides: Optional[Mapping[str, Any]] = None,
    base: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """The slice's flat config dict. ``overrides`` are in the YAML's units
    (fields of view in degrees) and are deep-merged over ``base``, a dict this
    function returned before (for example a checkpoint's), else over the
    defaults."""
    if base is None:
        config = _fov_to_radians(copy.deepcopy(_DEFAULTS))
    else:
        config = copy.deepcopy(dict(base))
    if overrides:
        _deep_merge(config, _fov_to_radians(copy.deepcopy(dict(overrides))))
    config["_fov_in_radians"] = True
    _validate(config)
    return config


def _validate(config: Mapping[str, Any]) -> None:
    if config["activation_fct"] not in ("relu", "tanh"):
        raise ValueError('activation_fct must be "relu" or "tanh"')
    if config["quaternion_normalization"] not in ("per_row", "global"):
        raise ValueError('quaternion_normalization must be "per_row" or "global"')
    if config["compute_dtype"] not in ("bfloat16", "float32"):
        raise ValueError('compute_dtype must be "bfloat16" or "float32"')
    for dataset in config["datasets"]:
        if dataset not in config:
            raise ValueError(f"Dataset {dataset!r} has no spec block in the config")
        for key in ("vertical_cells", "horizontal_cells", "max_points"):
            if key not in config[dataset]:
                raise ValueError(f"Dataset {dataset!r} spec missing {key!r}")
