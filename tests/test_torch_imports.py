"""The port stands alone: no JAX, no YAML, nothing of ``delora_tpu``; and its
entry points do not fall back to the CPU on their own."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "delora_tpu")
PORT_FILES = sorted((ROOT / "delora_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    assert len(PORT_FILES) > 10 and (ROOT / "chip_smoke.py").exists()
    # The kernel wrappers and the modules of every ported path are scanned.
    for module in ("ops/cuda/nn_search.py", "ops/cuda/window_match.py",
                   "ops/cuda/placement.py", "ops/correspondence.py", "ops/projection.py",
                   "training/step.py", "training/state.py", "training/trainer.py",
                   "models/resnet.py", "ops/eigh3.py", "ops/normals.py", "data/preprocess.py",
                   "data/dataset.py", "training/checkpoint.py", "training/tester.py", "cli.py",
                   "se3.py", "models/odometry.py", "config.py", "data/native_io.py",
                   "data/synthetic.py", "utils/torch_import.py", "utils/profiling.py",
                   "utils/plotting.py", "utils/visualize_normals.py", "parallel/dist.py",
                   "parallel/step.py", "parallel/multiprocess.py", "data/rosbag.py",
                   "data/export_sequence.py", "serving/ros_bridge.py",
                   "serving/ros_stubs.py", "bench.py"):
        assert ROOT / "delora_tpu_torch" / module in PORT_FILES, module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN and not m.startswith("delora_tpu_torch")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_point_without_device_refuses_cpu_only_host():
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.serving.stream import StreamingOdometry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = default_config({"kitti": {"max_points": 64, "vertical_cells": 8,
                                       "horizontal_cells": 32},
                             "resnet_outputs": 8, "layers": [1, 1, 1, 1],
                             "factor_fewer_resnet_channels": 16})
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingOdometry(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingOdometry(config, device="cuda")
