"""Rosbag-type datasets: the scans of a sequence from a ROS bag, or from its
per-scan ``.npy`` export.

The port of ``delora_tpu/data/rosbag.py``. A sequence ``<id>`` is read

- from the first ``<data_path>/<id>*.bag`` (name order): the PointCloud2
  messages on the spec's ``topic``, their x, y, z read with NaN rows
  skipped. Reading a bag needs the ROS1 Python packages ``rosbag`` and
  ``sensor_msgs``; where a bag exists and they do not, the reader raises
  ``ImportError`` rather than fall back to an export;
- else from the bag-export directory ``<data_path>/<id:02d>/`` (or
  ``<data_path>/<id>/``): one ``[N, >=3]`` ``.npy`` array a scan, in name
  order, as ``data/export_sequence.py`` writes them.

Each scan is filtered as the reference's bag extractor filters it: non-finite
points and points nearer than ``MIN_RANGE`` (0.3 m) are dropped, and x, y, z
are kept as float32. The reader can be iterated, not indexed: a bag is a
stream of messages.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional

import numpy as np

MIN_RANGE = 0.3


def filter_points(points: np.ndarray) -> np.ndarray:
    """``[N, >=3]`` -> the float32 x, y, z of the finite points at range
    ``MIN_RANGE`` or more."""
    points = points[:, :3].astype(np.float32)
    finite = np.isfinite(points).all(axis=-1)
    r = np.linalg.norm(points, axis=-1)
    return points[finite & (r >= MIN_RANGE)]


class RosbagSequenceReader:
    """Iterates the filtered scans of one sequence (see the module
    docstring); ``len`` is the number of messages on ``topic`` or of
    exported scans."""

    def __init__(self, data_path: str, sequence: int, topic: Optional[str] = None):
        self.topic = topic
        self._bag_path = None
        self._npy_files = []

        bags = sorted(glob.glob(os.path.join(data_path, f"{sequence}*.bag")))
        if bags:
            try:
                import rosbag  # noqa: F401
            except ImportError:
                raise ImportError(
                    f"Found bag file {bags[0]} but the 'rosbag' package is not "
                    "installed on this host. Export the bag to per-scan .npy "
                    "files (<data_path>/<id>/*.npy) instead.") from None
            self._bag_path = bags[0]
            return
        export_dir = os.path.join(data_path, format(sequence, "02d"))
        if not os.path.isdir(export_dir):
            export_dir = os.path.join(data_path, str(sequence))
        self._npy_files = sorted(glob.glob(os.path.join(export_dir, "*.npy")))
        if not self._npy_files:
            raise FileNotFoundError(
                f"No <id>*.bag under {data_path} and no exported scans under "
                f"{export_dir} (expected per-scan .npy arrays)")

    def __len__(self) -> int:
        if self._bag_path:
            import rosbag

            with rosbag.Bag(self._bag_path) as bag:
                return bag.get_message_count(topic_filters=[self.topic])
        return len(self._npy_files)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._bag_path:
            yield from self._iter_bag()
        else:
            for path in self._npy_files:
                yield filter_points(np.load(path))

    def _iter_bag(self) -> Iterator[np.ndarray]:
        import rosbag
        import sensor_msgs.point_cloud2 as pc2

        with rosbag.Bag(self._bag_path) as bag:
            for _, msg, _ in bag.read_messages(topics=[self.topic]):
                pts = np.array(list(pc2.read_points(msg, field_names=("x", "y", "z"),
                                                    skip_nans=True)), dtype=np.float32)
                yield filter_points(pts.reshape(-1, 3))
