"""Export a KITTI-layout sequence to the bag-export ``.npy`` layout or to a
ROS1 bag.

The port of ``scripts/export_kitti_sequence.py``. The default output is the
directory that ``data/rosbag.py::RosbagSequenceReader`` reads without ROS:
``<out_root>/<sequence>/NNNNNN.npy``, one float32 array a scan, ``[N, 3]``
x, y, z (``[N, 4]`` with the intensity under ``keep_intensity``). The
filter the reader applies to a bag's points (non-finite rows and ranges
below ``MIN_RANGE`` dropped) is applied here at export time, so replaying
the export matches replaying a bag.

With ``bag`` a ROS1 bag ``<out_root>/<sequence>.bag`` is written instead
(:func:`write_bag`; it needs ``rosbag``, ``rospy``, ``sensor_msgs`` and
``std_msgs``): one PointCloud2 a scan on ``/velodyne_points``, fields x, y, z
and intensity as FLOAT32, frame ``velodyne``, stamped 0.1 s apart from 0
(10 Hz, from t = 0 rather than the wall clock, so the file is
deterministic).

    python -m delora_tpu_torch.data.export_sequence <velodyne_dir> <out_root>
        [--sequence 07] [--limit K] [--keep-intensity] [--bag]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Iterable, Iterator, List, Optional

import numpy as np

from delora_tpu_torch.data.kitti import read_velodyne_bin
from delora_tpu_torch.data.rosbag import MIN_RANGE


def write_bag(scans: Iterable[np.ndarray], out_path: str, topic: str = "/velodyne_points",
              rate_hz: float = 10.0) -> int:
    """Write ``[N, 4]`` float32 scans to a ROS1 bag as PointCloud2 messages
    (x, y, z, intensity FLOAT32; frame ``velodyne``), one every
    ``1 / rate_hz`` seconds from t = 0 on ``topic``, each with a header of
    its own -> the number written."""
    try:
        import rosbag
        import rospy
        import sensor_msgs.msg
        import std_msgs.msg
        from sensor_msgs import point_cloud2
    except ImportError as e:
        raise ImportError(
            "--bag requires a ROS1 python environment (rosbag, rospy, "
            f"sensor_msgs, std_msgs importable): {e}") from e

    pf = sensor_msgs.msg.PointField
    fields = [pf(name=n, offset=4 * i, datatype=pf.FLOAT32, count=1)
              for i, n in enumerate(("x", "y", "z", "intensity"))]
    t = rospy.Time.from_sec(0.0)
    dt = rospy.Duration.from_sec(1.0 / rate_hz)
    count = 0
    with rosbag.Bag(out_path, "w") as bag:
        for scan in scans:
            header = std_msgs.msg.Header()
            header.frame_id = "velodyne"
            header.stamp = t
            bag.write(topic, point_cloud2.create_cloud(header, fields, scan), t)
            t += dt
            count += 1
    return count


def filtered_scans(files: Iterable[str], keep_intensity: bool) -> Iterator[np.ndarray]:
    """Each velodyne file's finite points at range ``MIN_RANGE`` or more, as
    float32 ``[N, 4]`` with ``keep_intensity``, else ``[N, 3]``."""
    for path in files:
        pts = read_velodyne_bin(path)
        xyz = pts[:, :3]
        keep = np.isfinite(pts).all(axis=-1) & (np.linalg.norm(xyz, axis=-1) >= MIN_RANGE)
        yield (pts[keep] if keep_intensity else xyz[keep]).astype(np.float32)


def velodyne_files(velodyne_dir: str, limit: Optional[int] = None) -> List[str]:
    """The ``*.bin`` scans of ``velodyne_dir`` in name order, the first
    ``limit`` of them if given; raises if there are none."""
    files = sorted(glob.glob(os.path.join(velodyne_dir, "*.bin")))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no *.bin scans in {velodyne_dir}")
    return files


def export_sequence(velodyne_dir: str, out_root: str, sequence: str = "07",
                    limit: Optional[int] = None, keep_intensity: bool = False,
                    bag: bool = False) -> str:
    """Export the scans of ``velodyne_dir`` (see the module docstring) -> the
    bag's path or the export directory."""
    files = velodyne_files(velodyne_dir, limit)
    os.makedirs(out_root, exist_ok=True)
    if bag:
        out_bag = os.path.join(out_root, sequence + ".bag")
        n = write_bag(filtered_scans(files, keep_intensity=True), out_bag)
        print(f"exported {n} scans -> {out_bag}", flush=True)
        return out_bag
    out_dir = os.path.join(out_root, sequence)
    os.makedirs(out_dir, exist_ok=True)
    for i, out in enumerate(filtered_scans(files, keep_intensity)):
        np.save(os.path.join(out_dir, format(i, "06d") + ".npy"), out)
    print(f"exported {len(files)} scans -> {out_dir}", flush=True)
    return out_dir


def main(argv: Optional[list] = None) -> str:
    ap = argparse.ArgumentParser(prog="python -m delora_tpu_torch.data.export_sequence")
    ap.add_argument("velodyne_dir", help="directory of KITTI *.bin scans")
    ap.add_argument("out_root", help="bag-export root (out_root/<sequence>/*.npy)")
    ap.add_argument("--sequence", default="07")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--keep-intensity", action="store_true",
                    help="write [N,4] x,y,z,intensity instead of [N,3]")
    ap.add_argument("--bag", action="store_true",
                    help="write <out_root>/<sequence>.bag (requires ROS1 python env) "
                         "instead of the .npy directory layout")
    args = ap.parse_args(argv)
    return export_sequence(args.velodyne_dir, args.out_root, args.sequence, args.limit,
                           args.keep_intensity, args.bag)


if __name__ == "__main__":
    main()
