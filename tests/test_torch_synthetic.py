"""The port's synthetic drive writer (``delora_tpu_torch/data/synthetic.py``)
against the JAX package's: for the same arguments every file of the KITTI
layout (velodyne ``.bin`` scans and the pose file) is byte for byte the
same. At most 8 scans a drive, so neither writer forks its process pool."""

import os

import numpy as np
import pytest

from delora_tpu.data import synthetic as jax_synthetic
from delora_tpu_torch.data import synthetic

CASES = {
    # seed, scans, step (m): 6 scans of 0.8 m keep the fixed world; 40 m
    # steps make a 200 m drive, which takes the trajectory-following world.
    "seed0": dict(seed=0, n_scans=6, step=0.8),
    "seed3": dict(seed=3, n_scans=8, step=0.8),
    "seed1-long-yawed": dict(seed=1, n_scans=6, step=40.0, yawed=True),
    "seed2-long": dict(seed=2, n_scans=5, step=40.0, yawed=False),
}


def tree(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_drive_files_equal_the_jax_writer(tmp_path, case):
    kw = dict(sequence=3, rings=16, azimuth_steps=180, **CASES[case])
    ours = synthetic.write_kitti_layout(str(tmp_path / "port"), **kw)
    theirs = jax_synthetic.write_kitti_layout(str(tmp_path / "jax"), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in ours] == [
        os.path.relpath(p, tmp_path / "jax") for p in theirs]
    a, b = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert sorted(a) == sorted(b) and len(a) == kw["n_scans"] + 1
    for name in a:
        assert a[name] == b[name], name


def test_missing_scans_are_written_again_the_same(tmp_path):
    """Per-scan seeding: a scan deleted and written again is the same file."""
    kw = dict(n_scans=4, rings=8, azimuth_steps=90, seed=5)
    seq_dir, _ = synthetic.write_kitti_layout(str(tmp_path), **kw)
    before = tree(tmp_path)
    os.remove(os.path.join(seq_dir, "000002.bin"))
    synthetic.write_kitti_layout(str(tmp_path), **kw)
    assert tree(tmp_path) == before


def test_world_and_scan_match_the_jax_functions():
    traj = synthetic.forward_trajectory(5, step=2.0)
    np.testing.assert_array_equal(traj, jax_synthetic.forward_trajectory(5, step=2.0))
    world, ref_world = synthetic.make_world(seed=4), jax_synthetic.make_world(seed=4)
    pose = traj[2]
    ours = synthetic.simulate_scan(world, pose, rings=8, azimuth_steps=90,
                                   rng=np.random.default_rng(1))
    theirs = jax_synthetic.simulate_scan(ref_world, pose, rings=8, azimuth_steps=90,
                                         rng=np.random.default_rng(1))
    np.testing.assert_array_equal(ours, theirs)
    assert len(ours) > 100
