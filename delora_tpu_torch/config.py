"""The settings of the ported slices, as Python data.

The same flat dict that ``delora_tpu.config.load_config()`` builds from its
YAML stack, cut to the keys the ported paths read: the KITTI sensor and
dataset spec, the normal-estimation keys, the deployment keys of the offline
pipeline (paths, checkpoints, evaluation, the feed), the model keys, and the
training, loss and correspondence keys. Values are those of
``delora_tpu/configs/*.yaml``; fields of view are written in degrees and
converted to radians once, by the same formula, so the floats are identical.
Keys the YAML leaves out or commented out (``lr_decay_steps``,
``lr_min_ratio``, ``seed``, ``eval_batch_size``, ``prewarm_cache``,
``prewarm_threads``, ``training_run_name``, ``auto_resume``, ``checkpoint``)
are read with the reference's defaults where they are used. Each dataset's
``data_identifiers`` follow the mode (training, testing or preprocessing) as
in the reference's ``load_config``.

Settings whose code is not ported yet raise in validation rather than run
silently: augmentation, projective correspondence, ``fused_adam``, the
cached-target feed (target cached, source raw), rosbag datasets, the native
C++ batcher (``native_io: true``) and ``profile_epochs``. Soft matching,
reverse po2pl, the parameter EMA, dropout and brute correspondence run.

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
    "min_num_points_in_neighborhood_to_determine_point_class": 10,
    "epsilon_range": 0.5,
    "kitti": {
        "training_identifiers": [0, 1, 2, 3, 4, 5, 6, 7, 8],
        "testing_identifiers": [9, 10],
        "vertical_field_of_view": [-24.5, 2.0],       # degrees
        "vertical_cells": 64,
        "horizontal_cells": 720,
        "horizontal_cells_preprocessing": 2250,
        "neighborhood_side_length": [7, 11],
        "max_points": 131072,
        "data_path": "./datasets/kitti/data_odometry_velodyne/dataset/sequences",
        "preprocessed_path": "./datasets/kitti/preprocessed/sequences",
        "pose_data_path": "./datasets/kitti/data_odometry_poses/dataset/poses",
        "dataset_type": "kitti",
    },
    # deployment.yaml
    "datasets": ["kitti"],
    "mode": "training",
    "experiment": "trainings_experiments_1",
    "store_dataset_in_RAM": True,
    "prefetch_depth": 2,
    "hbm_cache_scans": 3072,
    "native_io": "auto",
    "eval_every_epochs": 0,
    "inference_only": True,
    "visualize_images": True,
    "checkpoint_dir": "./checkpoints_tpu",
    "checkpoint_every_epochs": 1,
    "checkpoint_keep_every": 5,
    "log_dir": "./runs",
    "use_mlflow": False,
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


_MODES = ("training", "testing", "preprocessing")


def default_config(
    overrides: Optional[Mapping[str, Any]] = None,
    base: Optional[Mapping[str, Any]] = None,
    mode: Optional[str] = None,
) -> Dict[str, Any]:
    """The slice's flat config dict. ``overrides`` are in the YAML's units
    (fields of view in degrees) and are deep-merged over ``base``, a dict this
    function returned before (for example a checkpoint's), else over the
    defaults. ``mode`` (else the config's own) sets each dataset's
    ``data_identifiers``: the training identifiers, the testing ones, or for
    preprocessing the sorted union of both (reference config.py:83-97)."""
    config = _fov_to_radians(copy.deepcopy(_DEFAULTS))
    if base is not None:
        # A base from an older slice may lack the keys added since.
        _deep_merge(config, base)
    if overrides:
        _deep_merge(config, _fov_to_radians(copy.deepcopy(dict(overrides))))
    config["_fov_in_radians"] = True
    if mode is not None:
        config["mode"] = mode
    if config["mode"] not in _MODES:
        raise ValueError(f"Unknown mode: {config['mode']!r}")
    for dataset in config["datasets"]:
        spec = config.get(dataset, {})
        if config["mode"] == "training":
            spec["data_identifiers"] = list(spec.get("training_identifiers", []))
        elif config["mode"] == "testing":
            spec["data_identifiers"] = list(spec.get("testing_identifiers", []))
        else:
            spec["data_identifiers"] = sorted(set(spec.get("training_identifiers", []))
                                              | set(spec.get("testing_identifiers", [])))
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
    for dataset in config["datasets"]:
        kind = config.get(dataset, {}).get("dataset_type", "kitti")
        if kind != "kitti":
            raise NotImplementedError(
                f"dataset_type {kind!r} of {dataset!r} is not ported; the port reads KITTI "
                f"velodyne scans")
    if config.get("native_io", "auto") not in ("auto", False):
        raise NotImplementedError(
            f"native_io={config['native_io']!r} asks for the native C++ batcher, which is not "
            f"ported; the port's loader is the Python producer thread (native_io: auto)")
    if config.get("profile_epochs"):
        raise NotImplementedError("profile_epochs is not ported")
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
