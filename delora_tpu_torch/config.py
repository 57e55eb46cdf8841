"""The settings of the ported slices, as Python data.

The same flat dict that ``delora_tpu.config.load_config()`` builds from its
YAML stack, cut to the keys the serving and training paths read: the KITTI
sensor spec, the model keys, and the training, loss and correspondence keys.
Values are those of ``delora_tpu/configs/*.yaml``; fields of view are written
in degrees and converted to radians once, by the same formula, so the floats
are identical. Keys the YAML leaves commented out (``lr_decay_steps``,
``lr_min_ratio``, ``seed``) are read with the reference's defaults where they
are used.

Settings whose code is not ported yet raise in validation rather than run
silently: augmentation, projective correspondence, ``fused_adam`` and the
cached-target feed (target cached, source raw). Soft matching, reverse po2pl,
the parameter EMA, dropout and brute correspondence run.

``use_pallas_nn`` is carried for parity and read by nothing: the reference
picks between two routes to the same exact 1-NN with it (its Pallas kernel or
an XLA formula), and the port's brute search runs its one 1-NN kernel on the
card whatever it says.
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
    "unsupervised_at_start": False,
    "steps_per_dispatch": 32,
    "cache_target_projections": True,
    "cache_source_projections": True,
    # hyperparameters.yaml: training
    "batch_size": 32,
    "learning_rate": 0.00001,
    "lr_schedule": "constant",
    "lr_scaling": "none",
    "lr_scaling_base_batch": 32,
    "ema_decay": 0.0,
    "epochs": 10000,
    "use_dropout": False,
    "random_point_cloud_rotations": False,
    # hyperparameters.yaml: losses and correspondence
    "lambda_po2pl": 1.0,
    "normal_loss": "squared",
    "point_to_point_loss": False,
    "point_to_plane_loss": True,
    "plane_to_plane_loss": True,
    "po2po_alone": False,
    "correspondence": "image",
    "projective_window": [5, 9],
    "po2pl_trim_distance": 0.0,
    "soft_match_sigma": 0.0,
    "lambda_pl2pl": 1.0,
    "normalization_scaling": False,
    "lambda_reverse_po2pl": 0.0,
    "use_pallas_nn": False,
    # hyperparameters.yaml: model
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
    config = _fov_to_radians(copy.deepcopy(_DEFAULTS))
    if base is not None:
        # A base from an older slice may lack the keys added since.
        _deep_merge(config, base)
    if overrides:
        _deep_merge(config, _fov_to_radians(copy.deepcopy(dict(overrides))))
    config["_fov_in_radians"] = True
    validate(config)
    return config


# Settings whose code the port does not have yet: (key, value that is
# ported, what the other values would turn on).
_NOT_PORTED = (
    ("random_point_cloud_rotations", False, "augmentation"),
    ("fused_adam", False, "the flattened Adam update"),
)
_CORRESPONDENCE = ("image", "brute")


def training_feed(config: Mapping[str, Any]) -> str:
    """The trainer's feed, chosen as the reference's trainer chooses it
    (training/trainer.py:67-90): "full" (both scans' projections cached)
    when the target caches are on and the matcher works in image space,
    "raw" (padded clouds, projected in the step) when the correspondence is
    brute or the target cache is off, else "cached" (target cached, source
    raw), which is not ported."""
    if not config["cache_target_projections"] or config["correspondence"] == "brute":
        return "raw"
    return "full" if config["cache_source_projections"] else "cached"


def validate(config: Mapping[str, Any]) -> None:
    """Raise for a config the port cannot run: bad values, or settings whose
    code is not ported yet (NotImplementedError)."""
    if config["activation_fct"] not in ("relu", "tanh"):
        raise ValueError('activation_fct must be "relu" or "tanh"')
    if config["normal_loss"] not in ("squared", "linear"):
        raise ValueError('normal_loss must be "squared" or "linear"')
    if config["correspondence"] not in _CORRESPONDENCE:
        raise NotImplementedError(
            f"correspondence {config['correspondence']!r} is not ported; the port "
            f"has {' and '.join(_CORRESPONDENCE)}")
    for key, ported, what in _NOT_PORTED:
        if config.get(key, ported) != ported:
            raise NotImplementedError(
                f"{key}={config[key]!r} turns on {what}, which is not ported yet "
                f"(the port runs {key}={ported!r})")
    if training_feed(config) == "cached":
        raise NotImplementedError(
            "the cached-target feed (cache_target_projections: true, "
            "cache_source_projections: false) is not ported; the port has the fully "
            "cached and the raw feeds")
    if config["soft_match_sigma"] < 0.0 or config["lambda_reverse_po2pl"] < 0.0:
        raise ValueError("soft_match_sigma and lambda_reverse_po2pl must be >= 0")
    if not 0.0 <= config["ema_decay"] < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {config['ema_decay']}")
    if config["lr_schedule"] not in ("constant", "cosine"):
        raise ValueError('lr_schedule must be "constant" or "cosine"')
    window = config["projective_window"]
    if len(window) != 2 or any(int(w) < 1 or int(w) % 2 == 0 for w in window):
        raise ValueError(f"projective_window must be two odd sizes >= 1, got {window}")
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
