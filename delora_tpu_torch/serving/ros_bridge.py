"""ROS bridge of the streaming odometry engine (optional, import-gated).

The port of ``delora_tpu/serving/ros_bridge.py``: subscribe a PointCloud2
topic, run the model on consecutive scans with
:class:`delora_tpu_torch.serving.stream.StreamingOdometry` (on the card
unless ``device`` names another), and for each pair publish the relative
pose as ``nav_msgs/Odometry`` on ``/delora/odometry`` (frame ``lidar``) and
broadcast the integrated pose as the ``world -> lidar`` TF, both stamped
with the cloud's header stamp. The first scan of a stream publishes nothing.

Without ROS (``rospy``, ``tf2_ros``, ``geometry_msgs``, ``nav_msgs``,
``sensor_msgs``) importing this module works and ``ROS_AVAILABLE`` is
False; building the bridge then raises ``ImportError``. The JSONL engine
(``cli serve``) needs no ROS.

    from delora_tpu_torch.serving.ros_bridge import RosOdometryBridge
    RosOdometryBridge(config, checkpoint="...", device="cuda",
                      lidar_topic="/velodyne_points").spin()
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from delora_tpu_torch.utils.poses import rotmat_to_quat_xyzw_np

try:
    import rospy
    import sensor_msgs.point_cloud2 as pc2
    import tf2_ros
    from geometry_msgs.msg import TransformStamped
    from nav_msgs.msg import Odometry
    from sensor_msgs.msg import PointCloud2

    ROS_AVAILABLE = True
except ImportError:
    ROS_AVAILABLE = False


def _require_ros():
    if not ROS_AVAILABLE:
        raise ImportError(
            "rospy/tf2_ros not installed — the ROS bridge needs a ROS host. "
            "Use `python -m delora_tpu_torch.cli serve` (JSONL over stdin/stdout) "
            "elsewhere.")


def rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w), the convention of ROS's
    ``tf.transformations.quaternion_from_matrix``."""
    return rotmat_to_quat_xyzw_np(R)


class RosOdometryBridge:
    """PointCloud2 in -> Odometry + TF out, at the sensor's rate."""

    def __init__(self, config, checkpoint: Optional[str] = None, dataset: str = "kitti",
                 lidar_topic: str = "/velodyne_points", lidar_frame: str = "lidar",
                 world_frame: str = "world", odometry_topic: str = "/delora/odometry",
                 device=None):
        _require_ros()
        from delora_tpu_torch.serving.stream import StreamingOdometry

        self.engine = StreamingOdometry(config, checkpoint=checkpoint, device=device,
                                        dataset=dataset)
        self.lidar_frame = lidar_frame
        self.world_frame = world_frame

        rospy.init_node("delora_tpu_odometry", anonymous=True)
        self.pub = rospy.Publisher(odometry_topic, Odometry, queue_size=10)
        self.tf_broadcaster = tf2_ros.TransformBroadcaster()
        self.sub = rospy.Subscriber(lidar_topic, PointCloud2, self._callback, queue_size=1,
                                    buff_size=2 ** 24)

    def _callback(self, msg):
        pts = np.asarray(list(pc2.read_points(msg, field_names=("x", "y", "z"),
                                              skip_nans=True)), dtype=np.float32)
        out = self.engine.push_scan(pts.reshape(-1, 3))
        if out is None:
            return
        T_rel, pose, latency = out
        stamp = msg.header.stamp

        odom = Odometry()
        odom.header.stamp = stamp
        odom.header.frame_id = self.lidar_frame
        position = odom.pose.pose.position
        position.x, position.y, position.z = (float(v) for v in T_rel[:3, 3])
        orientation = odom.pose.pose.orientation
        (orientation.x, orientation.y, orientation.z,
         orientation.w) = rotmat_to_quat_np(T_rel[:3, :3])
        self.pub.publish(odom)

        tfm = TransformStamped()
        tfm.header.stamp = stamp
        tfm.header.frame_id = self.world_frame
        tfm.child_frame_id = self.lidar_frame
        translation = tfm.transform.translation
        translation.x, translation.y, translation.z = (float(v) for v in pose[:3, 3])
        rotation = tfm.transform.rotation
        rotation.x, rotation.y, rotation.z, rotation.w = rotmat_to_quat_np(pose[:3, :3])
        self.tf_broadcaster.sendTransform(tfm)

        rospy.loginfo_throttle(5.0, f"delora_tpu odometry latency {latency * 1000:.1f} ms")

    def spin(self):
        rospy.spin()
