"""The port's ROS half against the JAX package's, under stub ROS1 modules.

ROS cannot be installed here, so the tests place minimal in-memory
``rospy``, ``tf2_ros``, ``geometry_msgs``, ``nav_msgs``, ``sensor_msgs``,
``std_msgs`` and ``rosbag`` modules (``delora_tpu_torch/serving/ros_stubs.py``,
a copy of ``tests/test_ros_stubbed.py``'s stand-ins that ``chip_smoke.py``
shares) in ``sys.modules`` with ``monkeypatch``: message transport is faked,
and every line of both packages' message construction, frame bookkeeping,
bag writing and bag reading runs for real. Held:

- ``serving/ros_bridge.py``: the port's bridge and the JAX bridge, given the
  same Flax params (the port's from a trainer checkpoint holding
  ``params_from_jax``'s weights) and the same clouds (NaN and too-near rows
  included), publish the same number of Odometry and TF messages, with equal
  frames and stamps and poses within 1e-5;
- ``data/export_sequence.py::write_bag``'s records equal the JAX script's
  (topic, stamps 0.1 s apart, fields, frame, points), and the port makes a
  header for each message; the ``.npy`` export's files are bit-equal to the JAX
  script's (NaN and < 0.3 m rows dropped at export);
- ``data/rosbag.py``: a bag read back drops NaN and < 0.3 m rows, a wrong
  topic gives 0 messages, and the reader yields the JAX reader's arrays bit
  for bit, from a bag and from the ``.npy`` export (``NN/`` and ``N/``);
- ``data/preprocess.py`` on a rosbag-type dataset (from the export and from a
  bag): the scan files bit-equal to the JAX ``Preprocessor``'s and the normals
  within ``tests/test_torch_preprocess.py``'s tolerance;
- without the stubs the bridge and the bag writer raise ``ImportError``, a
  bag without ``rosbag`` raises ``ImportError``, and a sequence with neither
  a bag nor an export raises ``FileNotFoundError``.
"""

import importlib
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from delora_tpu_torch.config import default_config
from delora_tpu_torch.data import export_sequence
from delora_tpu_torch.data.rosbag import RosbagSequenceReader
from delora_tpu_torch.serving import ros_bridge as tbridge_module
from delora_tpu_torch.serving import ros_stubs

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)


def install_ros_stubs(monkeypatch):
    """The stand-ins as the ROS1 modules, in ``sys.modules`` until the
    test's monkeypatch is undone. -> the ``rospy`` stub (its
    ``throttled`` list records ``loginfo_throttle`` calls)."""
    modules = ros_stubs.stub_modules()
    for name, mod in modules.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return modules["rospy"]


@pytest.fixture
def bridges(monkeypatch):
    """Both packages' bridge modules reloaded against the stubs, and
    reloaded again without them afterwards."""
    from delora_tpu.serving import ros_bridge as jbridge_module

    rospy = install_ros_stubs(monkeypatch)
    importlib.reload(jbridge_module)
    importlib.reload(tbridge_module)
    assert jbridge_module.ROS_AVAILABLE and tbridge_module.ROS_AVAILABLE
    yield jbridge_module, tbridge_module, rospy
    monkeypatch.undo()
    importlib.reload(jbridge_module)
    importlib.reload(tbridge_module)


def export_script():
    """``scripts/export_kitti_sequence.py``, imported against the modules
    now in ``sys.modules``."""
    sys.path.insert(0, "scripts")
    try:
        return importlib.reload(importlib.import_module("export_kitti_sequence"))
    finally:
        sys.path.remove("scripts")


def odometry_values(odom):
    p, q = odom.pose.pose.position, odom.pose.pose.orientation
    return [p.x, p.y, p.z, q.x, q.y, q.z, q.w]


def tf_values(tfm):
    t, q = tfm.transform.translation, tfm.transform.rotation
    return [t.x, t.y, t.z, q.x, q.y, q.z, q.w]


def test_bridge_publishes_what_the_jax_bridge_publishes(bridges, tmp_path):
    from delora_tpu.config import load_config
    from delora_tpu_torch.training.checkpoint import CheckpointManager
    from delora_tpu_torch.utils.params import params_from_jax
    from tests.test_torch_serving import OVERRIDES, make_scans, random_flax_params

    jbridge_module, tbridge_module, rospy = bridges
    jbridge = jbridge_module.RosOdometryBridge(load_config(OVERRIDES, mode="testing"))
    params = random_flax_params(jbridge.engine.model, 16, 64)
    jbridge.engine.params = params
    config = default_config(OVERRIDES, mode="testing")
    CheckpointManager(str(tmp_path)).save({"model": params_from_jax(params)}, 0, 0.0, config)
    bridge = tbridge_module.RosOdometryBridge(config, checkpoint=str(tmp_path / "latest"),
                                              device="cpu")
    assert bridge.engine.device == torch.device("cpu")
    assert (bridge.pub.topic, bridge.pub.queue_size) == ("/delora/odometry", 10)
    assert (bridge.sub.topic, bridge.sub.queue_size, bridge.sub.buff_size) == (
        "/velodyne_points", 1, 2 ** 24)
    assert bridge.sub.callback == bridge._callback
    for k, scan in enumerate(make_scans(5)):
        scan[10] = [np.nan, 1.0, 1.0, 0.0]
        for b in (jbridge, bridge):
            header = SimpleNamespace(stamp=ros_stubs.Time(0.1 * k), frame_id="velodyne")
            b._callback(ros_stubs.PointCloud2(header=header, points=scan.copy()))
    assert len(bridge.pub.published) == len(jbridge.pub.published) == 4
    assert len(bridge.tf_broadcaster.sent) == len(jbridge.tf_broadcaster.sent) == 4
    for odom, ref in zip(bridge.pub.published, jbridge.pub.published):
        assert odom.header.frame_id == ref.header.frame_id == "lidar"
        assert odom.header.stamp == ref.header.stamp
        np.testing.assert_allclose(odometry_values(odom), odometry_values(ref), atol=1e-5)
    for tfm, ref in zip(bridge.tf_broadcaster.sent, jbridge.tf_broadcaster.sent):
        assert (tfm.header.frame_id, tfm.child_frame_id) == (ref.header.frame_id,
                                                              ref.child_frame_id)
        assert (tfm.header.frame_id, tfm.child_frame_id) == ("world", "lidar")
        assert tfm.header.stamp == ref.header.stamp
        np.testing.assert_allclose(tf_values(tfm), tf_values(ref), atol=1e-5)
    # The model must see something: the relative poses are not the identity.
    assert max(abs(v) for v in odometry_values(bridge.pub.published[-1])[:3]) > 1e-3
    assert len(rospy.throttled) == 8 and rospy.throttled[-1][0] == 5.0
    assert "odometry latency" in rospy.throttled[-1][1]


def bag_scans():
    rng = np.random.default_rng(7)
    scans = [rng.normal(size=(50, 4)).astype(np.float32) * 5 for _ in range(3)]
    scans[1][0] = [np.nan, 1, 1, 0]        # dropped by read_points' skip_nans
    scans[1][1] = [0.05, 0.05, 0.0, 1.0]   # dropped by the range filter (< 0.3 m)
    return scans


def test_write_bag_records_equal_the_jax_script(monkeypatch, tmp_path):
    install_ros_stubs(monkeypatch)
    scans = bag_scans()
    ours, theirs = str(tmp_path / "ours.bag"), str(tmp_path / "theirs.bag")
    ros_stubs.Header.made = 0
    assert export_sequence.write_bag(scans, ours) == 3
    assert ros_stubs.Header.made == 3       # a header of its own per message
    assert export_script().write_bag(scans, theirs) == 3
    records, ref = ros_stubs.Bag.store[ours], ros_stubs.Bag.store[theirs]
    assert len(records) == len(ref) == 3
    for i, ((topic, msg, t), (rtopic, rmsg, rt)) in enumerate(zip(records, ref)):
        assert topic == rtopic == "/velodyne_points"
        assert t == rt and t.to_sec() == pytest.approx(0.1 * i)
        np.testing.assert_array_equal(msg.points, rmsg.points)
        np.testing.assert_array_equal(msg.points, scans[i])
        assert [(f.name, f.offset, f.datatype, f.count) for f in msg.fields] == [
            (f.name, f.offset, f.datatype, f.count) for f in rmsg.fields] == [
            (n, 4 * k, ros_stubs.PointField.FLOAT32, 1)
            for k, n in enumerate(("x", "y", "z", "intensity"))]
        assert msg.header.frame_id == rmsg.header.frame_id == "velodyne"
        assert msg.header.stamp == rmsg.header.stamp
        assert msg.header.stamp.to_sec() == pytest.approx(0.1 * i)


def test_bag_round_trip_through_the_reader(monkeypatch, tmp_path):
    from delora_tpu.data.rosbag import RosbagSequenceReader as JaxReader

    install_ros_stubs(monkeypatch)
    scans = bag_scans()
    path = str(tmp_path / "7.bag")
    assert export_sequence.write_bag(scans, path) == 3
    reader = RosbagSequenceReader(str(tmp_path), 7, topic="/velodyne_points")
    assert reader._bag_path == path and len(reader) == 3
    read = list(reader)
    assert [s.shape for s in read] == [(50, 3), (48, 3), (50, 3)]
    np.testing.assert_array_equal(read[0], scans[0][:, :3])
    np.testing.assert_array_equal(read[1], scans[1][2:, :3])
    for ours, theirs in zip(read, JaxReader(str(tmp_path), 7, topic="/velodyne_points")):
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    # A wrong topic gives no message, as rosbag's topic filter does.
    empty = RosbagSequenceReader(str(tmp_path), 7, topic="/other")
    assert len(empty) == 0 and list(empty) == []


def write_velodyne(directory, n=4, seed=0):
    """KITTI velodyne files with NaN, zero and too-near rows."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for k in range(n):
        pts = (rng.normal(size=(300, 4)) * 6).astype(np.float32)
        pts[:4] = [[np.nan, 1, 1, 0], [0, 0, 0, 0], [0.1, 0.1, 0.1, 1], [1, 2, 3, np.nan]]
        pts.tofile(os.path.join(directory, f"{k:06d}.bin"))


@pytest.mark.parametrize("sequence, keep", [("07", False), ("7", True)])
def test_npy_export_and_reader_equal_the_jax_script_and_reader(tmp_path, monkeypatch,
                                                               sequence, keep):
    from delora_tpu.data.rosbag import RosbagSequenceReader as JaxReader

    velodyne = str(tmp_path / "velodyne")
    write_velodyne(velodyne)
    flags = ["--sequence", sequence, "--limit", "3"] + (["--keep-intensity"] if keep else [])
    ours = export_sequence.main([velodyne, str(tmp_path / "ours")] + flags)
    monkeypatch.setattr(sys, "argv", ["export_kitti_sequence.py", velodyne,
                                      str(tmp_path / "theirs")] + flags)
    export_script().main()
    assert ours == str(tmp_path / "ours" / sequence)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(tmp_path / "theirs" / sequence)) == [
        f"{k:06d}.npy" for k in range(3)]
    for name in names:
        a, b = np.load(os.path.join(ours, name)), np.load(tmp_path / "theirs" / sequence / name)
        assert a.dtype == b.dtype == np.float32 and a.shape[1] == (4 if keep else 3)
        np.testing.assert_array_equal(a, b)
        assert np.isfinite(a[:, :3]).all() and (np.linalg.norm(a[:, :3], axis=1) >= 0.3).all()
    reader = RosbagSequenceReader(str(tmp_path / "ours"), 7)
    assert len(reader) == 3
    for x, y in zip(reader, JaxReader(str(tmp_path / "theirs"), 7)):
        assert x.shape[1] == 3
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def rosbag_drive(tmp_path_factory):
    """Four ray-cast street scans as a rosbag-type dataset: sequence 0 as the
    ``.npy`` export, sequence 1 as a stub bag of the same scans."""
    from tests.test_torch_preprocess import drive_scan

    root = tmp_path_factory.mktemp("rosbag")
    rng = np.random.default_rng(0)
    scans = [drive_scan(k, rng)[0] for k in range(4)]
    os.makedirs(root / "data" / "00")
    for k, scan in enumerate(scans):
        np.save(root / "data" / "00" / f"{k:06d}.npy", scan)
    return root, scans


def rosbag_overrides(root, preprocessed, identifiers):
    return {"datasets": ["darpa"], "darpa": {
        "training_identifiers": identifiers, "testing_identifiers": identifiers,
        "vertical_field_of_view": [-24.5, 2.0], "vertical_cells": 16, "horizontal_cells": 64,
        "horizontal_cells_preprocessing": 360, "max_points": 4096,
        "neighborhood_side_length": [5, 7], "data_path": str(root / "data"),
        "preprocessed_path": str(root / preprocessed), "topic": "/velodyne_points"}}


@pytest.mark.parametrize("source", ["export", "bag"])
def test_rosbag_preprocessing_matches_the_jax_preprocessor(rosbag_drive, monkeypatch, source):
    from delora_tpu.config import load_config
    from delora_tpu.data.preprocess import Preprocessor as JaxPreprocessor
    from delora_tpu_torch.data.preprocess import Preprocessor
    from delora_tpu_torch.data.rosbag import filter_points
    from tests.test_torch_preprocess import check_normals

    root, scans = rosbag_drive
    seq = 0
    if source == "bag":
        install_ros_stubs(monkeypatch)
        seq = 1
        assert export_sequence.write_bag(scans, str(root / "data" / "1.bag")) == 4
    ours, theirs = f"ours_{source}", f"theirs_{source}"
    config = default_config(rosbag_overrides(root, ours, [seq]), mode="preprocessing")
    ref_config = load_config(rosbag_overrides(root, theirs, [seq]), mode="preprocessing")
    assert config["darpa"]["dataset_type"] == "rosbag"
    pre = Preprocessor(config, device="cpu")
    assert pre.run_dataset("darpa", max_scans=3) == 3
    assert JaxPreprocessor(ref_config).run_dataset("darpa", max_scans=3, progress=False) == 3
    held = 0
    for k in range(3):
        name = f"{seq:02d}/%s/{k:06d}.npy"
        scan, ref_scan = np.load(root / ours / (name % "scans")), np.load(
            root / theirs / (name % "scans"))
        np.testing.assert_array_equal(scan, ref_scan)
        assert 1000 < len(scan) < len(scans[k])
        out, ref = np.load(root / ours / (name % "normals")), np.load(
            root / theirs / (name % "normals"))
        monkeypatch_normals = pytest.MonkeyPatch()
        held += check_normals(out, ref, filter_points(scans[k]), scan, config, "darpa",
                              monkeypatch_normals)
    assert held > 1000
    assert not os.path.exists(root / ours / f"{seq:02d}" / "scans" / "000003.npy")
    assert pre.seconds["read"] > 0.0


def test_without_ros_the_bridge_and_bags_raise(tmp_path, monkeypatch):
    for name in ("rospy", "rosbag", "sensor_msgs", "sensor_msgs.point_cloud2", "std_msgs",
                 "tf2_ros"):
        monkeypatch.setitem(sys.modules, name, None)     # import raises ImportError
    module = importlib.reload(tbridge_module)
    try:
        assert not module.ROS_AVAILABLE
        with pytest.raises(ImportError, match="ROS host"):
            module.RosOdometryBridge(default_config(), device="cpu")
        with pytest.raises(ImportError, match="ROS1 python environment"):
            export_sequence.write_bag([np.zeros((1, 4), np.float32)], str(tmp_path / "x.bag"))
        open(tmp_path / "3.bag", "wb").close()
        with pytest.raises(ImportError, match="rosbag"):
            RosbagSequenceReader(str(tmp_path), 3)
        with pytest.raises(FileNotFoundError):
            RosbagSequenceReader(str(tmp_path), 4)
    finally:
        monkeypatch.undo()
        importlib.reload(tbridge_module)
