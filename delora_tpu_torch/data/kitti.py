"""KITTI odometry raw data: the velodyne scan reader and the sequence
iterator of ``delora_tpu/data/kitti.py``. A scan file is a flat
little-endian float32 array of (x, y, z, intensity) rows; a sequence is
``<data_path>/<seq:02d>/velodyne/*.bin`` in name order."""

from __future__ import annotations

import glob
import os
from typing import Iterator, List

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """One scan -> [N, 4] float32 (x, y, z, intensity)."""
    data = np.fromfile(path, dtype=np.float32)
    if data.size % 4 != 0:
        raise ValueError(f"Corrupt velodyne file (size % 4 != 0): {path}")
    return data.reshape(-1, 4)


class KittiSequenceReader:
    """Iterates the scans of one KITTI sequence directory."""

    def __init__(self, data_path: str, sequence: int):
        self.sequence_dir = os.path.join(data_path, format(sequence, "02d"))
        self.files: List[str] = sorted(
            glob.glob(os.path.join(self.sequence_dir, "velodyne", "*.bin")))
        if not self.files:
            raise FileNotFoundError(f"No velodyne scans under {self.sequence_dir}/velodyne")

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        return read_velodyne_bin(self.files[i])

    def __iter__(self) -> Iterator[np.ndarray]:
        for f in self.files:
            yield read_velodyne_bin(f)
