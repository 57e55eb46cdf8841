"""Minimal in-memory ROS1 modules, so that the bridge and the bag code run
where ROS is not installed.

``rospy``, ``tf2_ros``, ``geometry_msgs``, ``nav_msgs``, ``sensor_msgs``
(with ``point_cloud2``), ``std_msgs`` and ``rosbag`` stand-ins: message
transport is faked (publishers and the TF broadcaster keep what they are
given, a bag keeps its records in :attr:`Bag.store` by path), and every line
of the bridge's message construction, frame bookkeeping, bag writing and bag
reading runs for real. The tests and ``chip_smoke.py`` put them in
``sys.modules``; nothing in the package imports this module.

    modules = stub_modules()          # name -> module, to place by hand
    remove = install()                # placed now; remove() restores
"""

from __future__ import annotations

import sys
import types
from types import SimpleNamespace
from typing import Callable, Dict

import numpy as np


class Time:
    def __init__(self, sec=0.0):
        self.sec = float(sec)

    @classmethod
    def from_sec(cls, s):
        return cls(s)

    def to_sec(self):
        return self.sec

    def __add__(self, other):
        return Time(self.sec + other.sec)

    def __eq__(self, other):
        return isinstance(other, Time) and self.sec == other.sec


class Publisher:
    def __init__(self, topic, msg_type, queue_size=None):
        self.topic = topic
        self.msg_type = msg_type
        self.queue_size = queue_size
        self.published = []

    def publish(self, msg):
        self.published.append(msg)


class TransformBroadcaster:
    def __init__(self):
        self.sent = []

    def sendTransform(self, tfm):
        self.sent.append(tfm)


class Subscriber:
    def __init__(self, topic, msg_type, callback, queue_size=None, buff_size=None):
        self.topic = topic
        self.callback = callback
        self.queue_size = queue_size
        self.buff_size = buff_size


def _xyz_quat_pose():
    return SimpleNamespace(
        position=SimpleNamespace(x=0.0, y=0.0, z=0.0),
        orientation=SimpleNamespace(x=0.0, y=0.0, z=0.0, w=1.0),
    )


class Odometry:
    def __init__(self):
        self.header = SimpleNamespace(stamp=Time(), frame_id="")
        self.pose = SimpleNamespace(pose=_xyz_quat_pose())


class TransformStamped:
    def __init__(self):
        self.header = SimpleNamespace(stamp=Time(), frame_id="")
        self.child_frame_id = ""
        self.transform = SimpleNamespace(
            translation=SimpleNamespace(x=0.0, y=0.0, z=0.0),
            rotation=SimpleNamespace(x=0.0, y=0.0, z=0.0, w=1.0),
        )


class PointField:
    FLOAT32 = 7

    def __init__(self, name="", offset=0, datatype=0, count=1):
        self.name, self.offset = name, offset
        self.datatype, self.count = datatype, count


class PointCloud2:
    """PointCloud2 stand-in: carries the raw [N, k] array + header."""

    def __init__(self, header=None, fields=None, points=None):
        self.header = header or SimpleNamespace(stamp=Time(), frame_id="")
        self.fields = fields or []
        self.points = points


def read_points(msg, field_names=("x", "y", "z"), skip_nans=False):
    pts = np.asarray(msg.points, dtype=np.float32)[:, : len(field_names)]
    if skip_nans:
        pts = pts[np.isfinite(pts).all(axis=1)]
    return [tuple(row) for row in pts]


def create_cloud(header, fields, points):
    # Copy the header: the reference's writer mutates one Header in place per
    # message (reference convert_to_rosbag.py does the same).
    h = SimpleNamespace(stamp=header.stamp, frame_id=header.frame_id)
    return PointCloud2(header=h, fields=list(fields),
                       points=np.asarray(points, dtype=np.float32))


class Bag:
    """rosbag.Bag stand-in: (topic, msg, t) tuples, stored per path."""

    store = {}

    def __init__(self, path, mode="r"):
        self.path = path
        self.mode = mode
        self.records = [] if mode == "w" else Bag.store[path]

    def write(self, topic, msg, t):
        assert self.mode == "w"
        self.records.append((topic, msg, t))

    def get_message_count(self, topic_filters=None):
        if topic_filters and topic_filters != [None]:
            return sum(1 for r in self.records if r[0] in topic_filters)
        return len(self.records)

    def read_messages(self, topics=None):
        for topic, msg, t in self.records:
            if topics and topics != [None] and topic not in topics:
                continue
            yield topic, msg, t

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.mode == "w":
            Bag.store[self.path] = self.records
            open(self.path, "wb").close()           # the reader globs for the file
        return False


class Header:
    made = 0

    def __init__(self):
        Header.made += 1
        self.stamp = Time()
        self.frame_id = ""


def stub_modules() -> Dict[str, types.ModuleType]:
    """The stand-ins as the ROS1 modules, by module name, made anew. The
    ``rospy`` stub's ``throttled`` list records ``loginfo_throttle`` calls
    and its ``nodes`` list ``init_node`` calls."""
    rospy = types.ModuleType("rospy")
    rospy.nodes = []
    rospy.throttled = []
    rospy.init_node = lambda *a, **k: rospy.nodes.append((a, k))
    rospy.Publisher = Publisher
    rospy.Subscriber = Subscriber
    rospy.Time = Time
    rospy.Duration = Time
    rospy.loginfo_throttle = lambda period, text: rospy.throttled.append((period, text))
    rospy.spin = lambda: None

    geom = types.ModuleType("geometry_msgs")
    geom_msg = types.ModuleType("geometry_msgs.msg")
    geom_msg.TransformStamped = TransformStamped
    geom.msg = geom_msg

    nav = types.ModuleType("nav_msgs")
    nav_msg = types.ModuleType("nav_msgs.msg")
    nav_msg.Odometry = Odometry
    nav.msg = nav_msg

    sens = types.ModuleType("sensor_msgs")
    sens_msg = types.ModuleType("sensor_msgs.msg")
    sens_msg.PointCloud2 = PointCloud2
    sens_msg.PointField = PointField
    pc2 = types.ModuleType("sensor_msgs.point_cloud2")
    pc2.read_points = read_points
    pc2.create_cloud = create_cloud
    sens.msg = sens_msg
    sens.point_cloud2 = pc2

    std = types.ModuleType("std_msgs")
    std_msg = types.ModuleType("std_msgs.msg")
    std_msg.Header = Header
    std.msg = std_msg

    tf2 = types.ModuleType("tf2_ros")
    tf2.TransformBroadcaster = TransformBroadcaster

    rosbag_mod = types.ModuleType("rosbag")
    rosbag_mod.Bag = Bag

    return {"rospy": rospy, "geometry_msgs": geom, "geometry_msgs.msg": geom_msg,
            "nav_msgs": nav, "nav_msgs.msg": nav_msg, "sensor_msgs": sens,
            "sensor_msgs.msg": sens_msg, "sensor_msgs.point_cloud2": pc2,
            "std_msgs": std, "std_msgs.msg": std_msg, "tf2_ros": tf2,
            "rosbag": rosbag_mod}


def install() -> Callable[[], None]:
    """:func:`stub_modules` placed in ``sys.modules`` -> a function that
    puts back what those names held before."""
    modules = stub_modules()
    saved = {name: sys.modules.get(name) for name in modules}
    sys.modules.update(modules)

    def remove():
        for name, old in saved.items():
            if old is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = old

    return remove
