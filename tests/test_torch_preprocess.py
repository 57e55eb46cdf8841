"""The port's offline preprocessing (``delora_tpu_torch/data/preprocess.py``)
against the JAX package's ``Preprocessor.run_dataset`` on the same raw KITTI
layout: 8 ray-cast scans of a street (16 rings x 720 azimuth steps) projected
at 16x360, so neighbouring points share pixels, and more points than the
staging capacity (8,192), so the capacity rule cuts every scan.

Held: the scan files bit-equal (the same survivors in the same order: the
port's projection is bit-equal to the jitted reference's); the normal files
row-aligned with zero rows in the same places; the normals within
4e-6 * kappa wherever kappa <= 300 (``tests/test_torch_normals.py`` gives
the reason and the bound), unit length and toward the sensor elsewhere.

The module also holds the raw-layout and config helpers of the pipeline tests
(``tests/test_torch_{dataset,checkpoint,tester,cli,trainer_disk}.py``).
"""

import glob
import math
import os

import numpy as np
import pytest
import torch

from delora_tpu.config import load_config
from delora_tpu.data.preprocess import Preprocessor as JaxPreprocessor
from delora_tpu_torch.config import default_config
from delora_tpu_torch.data.preprocess import Preprocessor, staging_capacity
from delora_tpu_torch.ops import normals as tnormals
from delora_tpu_torch.ops.projection import ProjectionSpec, project_scan_batch
from delora_tpu_torch.utils.poses import TRANSFORM_LIDAR_TO_WORLD

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)

N_SCANS = 8


def drive_scan(k, rng, rings=16, steps=720):
    """Scan k of a sensor moving 0.8 m and 0.01 rad of yaw a scan down a
    street: ground at -1.73 m, facades at y = -7 and +9 m, a wall 40 m ahead
    of the start and a row of boxes; 2 cm range noise, 5% of rays lost.
    -> ([M, 4] float32 scan in the sensor frame, 4x4 sensor pose)."""
    yaw, origin = 0.01 * k, np.array([0.8 * k, 0.03 * k, 0.0])
    R = np.array([[math.cos(yaw), -math.sin(yaw), 0.0], [math.sin(yaw), math.cos(yaw), 0.0],
                  [0.0, 0.0, 1.0]])
    el = np.deg2rad(np.linspace(-24.0, 1.5, rings))
    az = np.linspace(-math.pi, math.pi, steps, endpoint=False) + rng.uniform(0, 0.005)
    e, a = np.meshgrid(el, az, indexing="ij")
    local = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                     -1).reshape(-1, 3)
    d = local @ R.T
    hits = np.full(len(d), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis, level in ((2, -1.73), (1, -7.0), (1, 9.0), (0, 40.0)):
            t = (level - origin[axis]) / d[:, axis]
            hits = np.where((t > 0) & (t < hits), t, hits)
        for bx in np.arange(4.0, 30.0, 6.0):            # boxes 1 m wide on the right
            t = (5.0 - origin[1]) / d[:, 1]
            x = origin[0] + t * d[:, 0]
            z = t * d[:, 2]
            inside = (t > 0) & (np.abs(x - bx) < 0.5) & (z < 1.0) & (t < hits)
            hits = np.where(inside, t, hits)
    keep = (hits < 60.0) & (rng.random(len(hits)) > 0.05)
    r = hits[keep] + rng.normal(0, 0.02, keep.sum())
    pts = local[keep] * r[:, None]
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = R, origin
    return np.c_[pts, rng.random(len(pts))].astype(np.float32), pose


def write_drive(root, n_scans=N_SCANS, seq=0, seed=0):
    """The KITTI raw layout: ``<root>/raw/<seq>/velodyne/NNNNNN.bin`` and
    the camera-frame poses ``<root>/poses/<seq>.txt``."""
    rng = np.random.default_rng(seed)
    velodyne = os.path.join(root, "raw", f"{seq:02d}", "velodyne")
    os.makedirs(velodyne, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    rows = []
    for k in range(n_scans):
        scan, pose = drive_scan(k, rng)
        scan.tofile(os.path.join(velodyne, f"{k:06d}.bin"))
        camera = TRANSFORM_LIDAR_TO_WORLD @ pose @ TRANSFORM_LIDAR_TO_WORLD.T
        rows.append(camera[:3].reshape(-1))
    np.savetxt(os.path.join(root, "poses", f"{seq:02d}.txt"), np.asarray(rows))


def overrides(root, **extra):
    """Config overrides of the pipeline tests: a narrow model, 16x64 at train
    time, 16x360 with 5x7 patches for preprocessing, fp32, B = 2."""
    root = str(root)
    kitti = {"training_identifiers": [0], "testing_identifiers": [0],
             "vertical_cells": 16, "horizontal_cells": 64,
             "horizontal_cells_preprocessing": 360, "max_points": 4096,
             "neighborhood_side_length": [5, 7],
             "data_path": os.path.join(root, "raw"),
             "preprocessed_path": os.path.join(root, "preprocessed"),
             "pose_data_path": os.path.join(root, "poses")}
    kitti.update(extra.pop("kitti", {}))
    out = {"datasets": ["kitti"], "kitti": kitti, "batch_size": 2, "learning_rate": 1e-4,
           "resnet_outputs": 32, "layers": [1, 1, 1, 1], "factor_fewer_resnet_channels": 16,
           "compute_dtype": "float32", "checkpoint_dir": os.path.join(root, "ckpt"),
           "log_dir": os.path.join(root, "runs"), "unsupervised_at_start": True,
           "visualize_images": False}
    out.update(extra)
    return out


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    root = tmp_path_factory.mktemp("pre")
    write_drive(str(root))
    port_cfg = default_config(overrides(root), mode="preprocessing")
    ref_cfg = load_config(overrides(root, kitti={
        "preprocessed_path": str(root / "reference")}), mode="preprocessing")
    n_ref = JaxPreprocessor(ref_cfg).run_dataset("kitti", progress=False)
    pre = Preprocessor(port_cfg, device="cpu")
    n = pre.run_dataset("kitti")
    return root, port_cfg, pre, n, n_ref


def files(root, kind):
    return sorted(glob.glob(os.path.join(str(root), kind)))


def test_same_scans_written(preprocessed):
    root, config, pre, n, n_ref = preprocessed
    assert n == n_ref == N_SCANS
    ours = files(root, "preprocessed/00/scans/*.npy")
    ref = files(root, "reference/00/scans/*.npy")
    assert [os.path.basename(f) for f in ours] == [os.path.basename(f) for f in ref]
    capacity = staging_capacity(config, "kitti", ProjectionSpec.from_config(
        config, "kitti", preprocessing=True))
    assert capacity == 8192
    for a, b in zip(ours, ref):
        scan, scan_ref = np.load(a), np.load(b)
        assert scan.dtype == np.float32 and scan.shape[1] == 3
        np.testing.assert_array_equal(scan, scan_ref)
        assert 4000 < len(scan) < capacity          # deduplicated and cut
    assert set(pre.seconds) == {"read", "device", "write"}


def check_normals(out, ref, points, scan, config, dataset, monkeypatch):
    """One scan's normal files against the reference's (see the module
    docstring): ``points`` are the raw points the preprocessor staged (at
    most its capacity), ``scan`` the scan file. -> the count of normals held
    to 4e-6 * kappa."""
    spec = tnormals.NormalsSpec.from_config(config, dataset)
    pspec = ProjectionSpec.from_config(config, dataset, preprocessing=True)
    capacity = staging_capacity(config, dataset, pspec)
    assert out.shape == ref.shape == scan.shape
    has = (ref != 0).any(-1)
    np.testing.assert_array_equal((out != 0).any(-1), has)
    assert has.mean() > 0.5
    # Each survivor's pixel and the covariance the port's solver saw there.
    pts = points[:capacity, :3]
    padded = torch.zeros(1, capacity, 3)
    padded[0, :len(pts)] = torch.from_numpy(pts)
    valid = torch.zeros(1, capacity, dtype=torch.bool)
    valid[0, :len(pts)] = True
    proj = project_scan_batch(padded, valid, pspec)
    seen = []
    solver = tnormals.smallest_eigenvector_sym3x3
    monkeypatch.setattr(tnormals, "smallest_eigenvector_sym3x3",
                        lambda A, eps=1e-20: seen.append(A) or solver(A, eps))
    tnormals.compute_normal_image(proj.image[0, ..., :3], spec)
    monkeypatch.undo()
    w = np.linalg.eigvalsh(seen[0].numpy().astype(np.float64)).reshape(-1, 3)
    kappa = np.abs(w).max(-1) / np.maximum(w[:, 1] - w[:, 0], 1e-30)
    surv = proj.survivor[0].numpy()
    u = np.clip(np.round(proj.u[0].numpy()[surv]).astype(int), 0, pspec.width - 1)
    v = np.clip(np.round(proj.v[0].numpy()[surv]).astype(int), 0, pspec.height - 1)
    kappa = kappa[v * pspec.width + u]
    held = has & (kappa <= 300.0)
    diff = np.abs(out - ref).max(-1)
    assert (diff[held] <= 4e-6 * kappa[held]).all(), f"worst {diff[held].max()}"
    np.testing.assert_allclose(np.linalg.norm(out[has], axis=-1), 1.0, atol=1e-5)
    assert ((out * scan).sum(-1)[has] <= 1e-4).all()
    return held.sum()


def test_normals_match_the_reference(preprocessed, monkeypatch):
    root, config, _, _, _ = preprocessed
    raw = files(root, "raw/00/velodyne/*.bin")
    held_total = 0
    for k, (a, b) in enumerate(zip(files(root, "preprocessed/00/normals/*.npy"),
                                   files(root, "reference/00/normals/*.npy"))):
        pts = np.fromfile(raw[k], np.float32).reshape(-1, 4)
        held_total += check_normals(np.load(a), np.load(b), pts,
                                    np.load(a.replace("normals", "scans")), config, "kitti",
                                    monkeypatch)
    assert held_total > 0.7 * sum(
        (np.load(f) != 0).any(-1).sum() for f in files(root, "reference/00/normals/*.npy"))


def test_preprocessing_runs_on_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Preprocessor(default_config(overrides(tmp_path), mode="preprocessing"))
