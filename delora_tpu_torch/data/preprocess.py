"""Offline preprocessing: raw scans -> deduplicated point lists + normals.

The port of ``delora_tpu/data/preprocess.py``. Per scan, on the device: the
projection at the preprocessing width (``horizontal_cells_preprocessing``)
through the exact-rule placement kernel (``ops/projection.py::
project_scan_batch``), then the neighbourhood-PCA normals
(``ops/normals.py``). It writes the reference's on-disk contract:

    <preprocessed_path>/<seq:02d>/scans/NNNNNN.npy     [M, 3] float32 xyz
    <preprocessed_path>/<seq:02d>/normals/NNNNNN.npy   [M, 3] float32

The scan file holds the points that won their pixel, in their original
order; the normals are row-aligned with them, zero where no normal exists.
Raw scans come from the reader of the dataset's ``dataset_type``: KITTI
velodyne files (``data/kitti.py``) or a rosbag sequence (``data/rosbag.py``:
a bag's PointCloud2 messages or their ``.npy`` export), iterated in order.
``preview`` renders the first scan's range and normal images instead (the
reference's single-image preprocessing preview; it needs matplotlib).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from delora_tpu_torch import resolve_device
from delora_tpu_torch.data.kitti import KittiSequenceReader
from delora_tpu_torch.data.rosbag import RosbagSequenceReader
from delora_tpu_torch.ops.normals import NormalsSpec, compute_normal_image, normals_for_points
from delora_tpu_torch.ops.projection import ProjectionSpec, project_scan_batch


def staging_capacity(config, dataset: str, pspec: ProjectionSpec) -> int:
    """Points a scan is padded (or cut) to: ``max_points``, or the projection
    grid rounded up to 4096 if larger (an upper bound on the survivors), as
    the reference sizes its staging buffer."""
    return max(int(config[dataset]["max_points"]),
               -(-pspec.height * pspec.width // 4096) * 4096)


class Preprocessor:
    """Drives per-dataset, per-sequence preprocessing on ``device`` (CUDA
    unless the caller names another). ``seconds`` accumulates the host-clock
    time of each part over the scans it wrote: "read" (the raw file), "device"
    (upload, projection, normals and the readback) and "write" (both .npy
    files)."""

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.seconds: Dict[str, float] = {"read": 0.0, "device": 0.0, "write": 0.0}

    def preprocess_scan(self, xyz: np.ndarray, pspec: ProjectionSpec, nspec: NormalsSpec,
                        capacity: int):
        """One raw scan ``[M, 3]`` -> (surviving points, their normals, the
        count of points dropped beyond ``capacity``)."""
        n = min(len(xyz), capacity)
        points = np.zeros((capacity, 3), np.float32)
        points[:n] = xyz[:n]
        pts = torch.from_numpy(points).to(self.device)
        valid = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        valid[:n] = True
        proj = project_scan_batch(pts[None], valid[None], pspec)
        normals = normals_for_points(proj.image[0, ..., :3], proj.u[0], proj.v[0],
                                     proj.survivor[0], nspec)
        survivor = proj.survivor[0].cpu().numpy()
        return points[survivor], normals.cpu().numpy()[survivor], len(xyz) - n

    def preview_images(self, dataset: str, sequence: Optional[int] = None):
        """The first scan of ``sequence`` (else of the first identifier),
        padded to ``max_points`` and projected at the preprocessing width
        (one exact placement on the card) -> (range image [H, W], normal
        image [H, W, 3]), as numpy arrays (reference preprocess.py:78-107)."""
        spec = self.config[dataset]
        pspec = ProjectionSpec.from_config(self.config, dataset, preprocessing=True)
        nspec = NormalsSpec.from_config(self.config, dataset)
        seq = sequence if sequence is not None else spec["data_identifiers"][0]
        raw = next(iter(self._make_reader(dataset, seq)))[:, :3].astype(np.float32)
        capacity = int(spec["max_points"])
        n = min(len(raw), capacity)
        points = torch.zeros(capacity, 3, device=self.device)
        points[:n] = torch.from_numpy(raw[:n]).to(self.device)
        valid = torch.arange(capacity, device=self.device) < n
        image = project_scan_batch(points[None], valid[None], pspec).image[0]
        normals = compute_normal_image(image[..., :3], nspec)
        return image[..., 3].cpu().numpy(), normals.cpu().numpy()

    def preview(self, dataset: str, sequence: Optional[int] = None,
                out_path: Optional[str] = None) -> str:
        """Render :meth:`preview_images` as four stacked panels (range,
        normal x, y, z) into ``out_path`` (else
        ``<log_dir>/preprocess_preview.png``) -> the path."""
        from delora_tpu_torch.utils.plotting import plot_range_image_grid

        if out_path is None:
            out_path = os.path.join(self.config.get("log_dir", "./runs"),
                                    "preprocess_preview.png")
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        ranges, normals = self.preview_images(dataset, sequence)
        plot_range_image_grid([ranges, normals[..., 0], normals[..., 1], normals[..., 2]],
                              ["range", "normal x", "normal y", "normal z"], out_path)
        print(f"[preprocess] preview -> {out_path}", flush=True)
        return out_path

    def run_dataset(self, dataset: str, max_scans: Optional[int] = None) -> int:
        """Preprocess the dataset's ``data_identifiers``, at most
        ``max_scans`` a sequence -> the number of scans written."""
        spec = self.config[dataset]
        pspec = ProjectionSpec.from_config(self.config, dataset, preprocessing=True)
        nspec = NormalsSpec.from_config(self.config, dataset)
        capacity = staging_capacity(self.config, dataset, pspec)
        total = 0
        for seq in spec["data_identifiers"]:
            reader = self._make_reader(dataset, seq)
            out_dir = os.path.join(spec["preprocessed_path"], format(seq, "02d"))
            scans_dir = os.path.join(out_dir, "scans")
            normals_dir = os.path.join(out_dir, "normals")
            os.makedirs(scans_dir, exist_ok=True)
            os.makedirs(normals_dir, exist_ok=True)
            scans = iter(reader)
            for i in itertools.count():
                if max_scans is not None and i >= max_scans:
                    break
                t0 = time.perf_counter()
                raw = next(scans, None)
                t1 = time.perf_counter()
                if raw is None:
                    break
                scan, normals, dropped = self.preprocess_scan(
                    raw[:, :3].astype(np.float32), pspec, nspec, capacity)
                t2 = time.perf_counter()
                if dropped > 0:
                    print(f"[preprocess] {dataset}/{seq:02d}/{i:06d}: "
                          f"dropped {dropped} points beyond capacity {capacity}")
                np.save(os.path.join(scans_dir, format(i, "06d") + ".npy"), scan)
                np.save(os.path.join(normals_dir, format(i, "06d") + ".npy"), normals)
                t3 = time.perf_counter()
                for key, dt in (("read", t1 - t0), ("device", t2 - t1), ("write", t3 - t2)):
                    self.seconds[key] += dt
                total += 1
                if i % 100 == 0:
                    print(f"[preprocess] {dataset}/{seq:02d}: scan {i}", flush=True)
        return total

    def _make_reader(self, dataset: str, seq: int):
        """The raw scans of sequence ``seq`` by the dataset's
        ``dataset_type`` (reference preprocess.py:153-162)."""
        spec = self.config[dataset]
        kind = spec.get("dataset_type", "kitti")
        if kind == "kitti":
            return KittiSequenceReader(spec["data_path"], seq)
        if kind == "rosbag":
            return RosbagSequenceReader(spec["data_path"], seq, spec.get("topic"))
        raise ValueError(f"Unknown dataset_type {kind!r} for {dataset!r}")
