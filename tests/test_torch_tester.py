"""The port's ``Tester`` (``delora_tpu_torch/training/tester.py``) against the
JAX package's on the same preprocessed drive and the same parameters
(``utils/params.py::params_from_jax``), fp32: the pose file within 1e-5, the
KITTI t_rel / r_rel (ground truth spaced 20 m a scan, so 100 m segments
exist) or the per-step RPE (the drive's own 0.8 m a scan) within 1e-4
relative, on the cached and the uncached path, and the evaluated losses
(image and projective matchers) within rtol 1e-4. The pose utilities (``utils/poses.py``) equal the JAX
package's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delora_tpu.config import load_config
from delora_tpu.models.odometry import ModelConfig as JaxModelConfig
from delora_tpu.models.odometry import OdometryModel as JaxOdometryModel
from delora_tpu.training.state import create_train_state
from delora_tpu.training.tester import Tester as JaxTester
from delora_tpu.utils import poses as jposes
from delora_tpu_torch.config import default_config
from delora_tpu_torch.data.preprocess import Preprocessor
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.training.tester import Tester as PortTester
from delora_tpu_torch.utils import poses as tposes
from delora_tpu_torch.utils.params import params_from_jax
from tests.test_torch_preprocess import TRANSFORM_LIDAR_TO_WORLD, overrides, write_drive

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("tester")
    write_drive(str(root))
    Preprocessor(default_config(overrides(root), mode="preprocessing"),
                 device="cpu").run_dataset("kitti")
    # Ground truth 20 m apart: segments of 100 m and more.
    rows = []
    for k in range(8):
        pose = np.eye(4)
        pose[:3, :3] = np.array([[np.cos(0.02 * k), -np.sin(0.02 * k), 0.0],
                                 [np.sin(0.02 * k), np.cos(0.02 * k), 0.0], [0.0, 0.0, 1.0]])
        pose[:3, 3] = [20.0 * k, 0.5 * k, 0.0]
        rows.append((TRANSFORM_LIDAR_TO_WORLD @ pose @ TRANSFORM_LIDAR_TO_WORLD.T)[:3].ravel())
    os.makedirs(root / "long_poses")
    np.savetxt(root / "long_poses" / "00.txt", np.asarray(rows))
    ref_cfg = load_config(overrides(root), mode="testing")
    model = JaxOdometryModel(JaxModelConfig.from_config(ref_cfg))
    state = create_train_state(model, ref_cfg, jnp.zeros((2, 16, 64, 4)))
    port_model = OdometryModel(ModelConfig.from_config(default_config(overrides(root))))
    port_model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, state.params)))
    return root, state, port_model.eval()


CASES = {"rpe-cached": {}, "rpe-uncached": {"cache_target_projections": False},
         "t_rel": {"kitti": {"pose_data_path": "long_poses"}}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_and_metrics_match_jax(world, case):
    root, state, model = world
    extra = dict(CASES[case])
    kitti = extra.pop("kitti", {})
    if kitti:
        kitti = {"pose_data_path": str(root / kitti["pose_data_path"])}
    cfg = overrides(root, kitti=kitti, **extra)
    ref = JaxTester(load_config(cfg, mode="testing"), state=state, run_name=f"jax_{case}")
    port = PortTester(default_config(cfg, mode="testing"), model=model, device="cpu",
                      run_name=f"port_{case}")
    want = ref.test()["kitti"][0]
    got = port.test()["kitti"][0]
    assert want is not None and len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)
    files = [os.path.join(t.logger.run_dir, "artifacts", "poses_kitti_00.txt")
             for t in (port, ref)]
    ours, theirs = (tposes.read_poses_from_text_file(f) for f in files)
    assert ours.shape == (8, 4, 4)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    for name in ("transformations_kitti_00.npy", "poses_kitti_00.npy"):
        assert os.path.exists(os.path.join(port.logger.run_dir, "artifacts", name))


def test_evaluated_losses_match_jax(world):
    root, state, model = world
    cfg = overrides(root)
    ref = JaxTester(load_config(cfg, mode="testing"), state=state, run_name="jax_losses")
    port = PortTester(default_config(cfg, mode="testing"), model=model, device="cpu",
                      run_name="port_losses")
    want = ref.evaluate_losses("kitti", 0)
    got = port.evaluate_losses("kitti", 0)
    for key in ("loss", "loss_pc", "loss_po2pl", "loss_pl2pl", "num_po2pl_pairs"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def test_tester_loads_the_checkpoints_deploy_weights(world, tmp_path):
    """From a checkpoint, the Tester evaluates the EMA when the state holds
    one, else the model."""
    from delora_tpu_torch.training.checkpoint import CheckpointManager

    root, _, model = world
    ema = {k: v + 0.01 for k, v in model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_named({"model": model.state_dict(), "ema": ema}, "best", 0, 0.0, {})
    mgr.save_named({"model": model.state_dict()}, "plain", 0, 0.0, {})
    for name, weights in (("best", ema), ("plain", model.state_dict())):
        cfg = default_config(overrides(root, checkpoint=str(tmp_path / name)), mode="testing")
        loaded = PortTester(cfg, device="cpu", run_name=f"ckpt_{name}").model
        assert not loaded.training
        for key, value in loaded.state_dict().items():
            assert torch.equal(value, weights[key]), key


def test_pose_utilities_equal_jax():
    rng = np.random.default_rng(0)
    rel = []
    for _ in range(30):
        T = np.eye(4)
        q = rng.normal(size=4) * np.array([0.02, 0.02, 0.05, 1.0])
        T[:3, :3] = jposes.Rotation.from_quat(q / np.linalg.norm(q)).as_matrix()
        T[:3, 3] = rng.normal(size=3) * np.array([8.0, 0.5, 0.1])
        rel.append(T)
    poses = tposes.compute_poses(rel)
    np.testing.assert_array_equal(poses, jposes.compute_poses(rel))
    gt = jposes.compute_poses(rel[::-1])
    np.testing.assert_array_equal(tposes.trajectory_distances(poses),
                                  jposes.trajectory_distances(poses))
    assert tposes.kitti_odometry_errors(gt, poses) == jposes.kitti_odometry_errors(gt, poses)
    assert tposes.kitti_benchmark_summary(gt, poses) == jposes.kitti_benchmark_summary(gt, poses)
    assert tposes.kitti_benchmark_summary(gt, poses) is not None
    assert (tposes.relative_pose_errors_summary(gt, poses)
            == jposes.relative_pose_errors_summary(gt, poses))
    assert tposes.relative_pose_errors_summary(gt[:1], poses[:1]) is None
    assert tposes.kitti_benchmark_summary(gt[:3], poses[:3]) is None


def test_pose_files_round_trip_as_jax(tmp_path):
    poses = tposes.compute_poses([np.eye(4)] * 3)
    tposes.write_poses_to_text_file(str(tmp_path / "a.txt"), poses)
    jposes.write_poses_to_text_file(str(tmp_path / "b.txt"), poses)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    np.testing.assert_array_equal(tposes.read_poses_from_text_file(str(tmp_path / "a.txt")),
                                  jposes.read_poses_from_text_file(str(tmp_path / "b.txt")))


def test_evaluated_projective_losses_match_jax(world):
    """The loss evaluation with projective correspondence, as the reference's."""
    root, state, model = world
    cfg = overrides(root, correspondence="projective")
    ref = JaxTester(load_config(cfg, mode="testing"), state=state, run_name="jax_proj_losses")
    port = PortTester(default_config(cfg, mode="testing"), model=model, device="cpu",
                      run_name="port_proj_losses")
    want = ref.evaluate_losses("kitti", 0)
    got = port.evaluate_losses("kitti", 0)
    assert want["num_po2pl_pairs"] > 10
    for key in ("loss", "loss_pc", "loss_po2pl", "loss_pl2pl", "num_po2pl_pairs"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
