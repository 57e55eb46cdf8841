"""``ctypes`` binding of the port's host IO runtime, ``csrc/delora_io.cpp``.

The port of ``delora_tpu/data/native_io.py``: threaded ``.npy`` / ``.bin``
reading and padding into fixed-shape batch buffers, GIL-free, plus the host
spherical projection. Where the reference's binding returns None when its
library is missing, this one builds the library at first use (the host C++
compiler, into ``delora_tpu_torch/build/``) and raises if the build fails.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List

import numpy as np

from delora_tpu_torch.ops.cuda.build import load_library

_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_ubyte)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built IO library with its signatures declared (built at first
    use; raises if the build fails)."""
    lib = load_library("delora_io")
    lib.dio_read_velodyne.restype = ctypes.c_int
    lib.dio_read_velodyne.argtypes = [ctypes.c_char_p, _F32, ctypes.c_int]
    lib.dio_read_npy_f32.restype = ctypes.c_int
    lib.dio_read_npy_f32.argtypes = [ctypes.c_char_p, _F32, ctypes.c_int, ctypes.c_int]
    lib.dio_loader_create.restype = ctypes.c_void_p
    lib.dio_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dio_loader_request.restype = ctypes.c_long
    lib.dio_loader_request.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_int]
    lib.dio_loader_next.restype = ctypes.c_int
    lib.dio_loader_next.argtypes = [ctypes.c_void_p] + [_F32, _F32, _U8] * 2
    lib.dio_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.dio_project_scan.restype = ctypes.c_int
    lib.dio_project_scan.argtypes = [
        _F32, _U8, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _F32, ctypes.POINTER(ctypes.c_int32), _F32]
    return lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(_F32)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8)


def read_velodyne_native(path: str, capacity: int = 200_000) -> np.ndarray:
    """A KITTI velodyne ``.bin`` -> [N, 4] float32, at most ``capacity`` rows."""
    buf = np.empty((capacity, 4), np.float32)
    n = library().dio_read_velodyne(path.encode(), _f32(buf), capacity)
    if n < 0:
        raise IOError(f"native velodyne read failed: {path}")
    return buf[:n].copy()


def read_npy_native(path: str, capacity: int, cols: int = 3) -> np.ndarray:
    """A little-endian float32 C-order ``.npy`` [N, cols] -> its first
    ``capacity`` rows."""
    buf = np.empty((capacity, cols), np.float32)
    n = library().dio_read_npy_f32(path.encode(), _f32(buf), capacity, cols)
    if n < 0:
        raise IOError(f"native npy read failed: {path}")
    return buf[:n].copy()


def project_scan_native(points: np.ndarray, valid: np.ndarray, spec):
    """The C++ twin of ``ops/projection_host.py::project_scan_np`` -> (image
    [H, W, 4] float32, point_index [H, W] int32, mean range). The same
    winners (scatter-min with a strict '<': the smallest index wins exact
    range ties); the mean range is summed in double, so it may be an ulp
    away from the numpy route's."""
    pts = np.ascontiguousarray(np.asarray(points, np.float32)[:, :3])
    val = np.ascontiguousarray(np.asarray(valid), np.uint8)
    H, W = spec.height, spec.width
    image = np.zeros((H, W, 4), np.float32)
    point_index = np.zeros((H, W), np.int32)
    mean_range = ctypes.c_float(0.0)
    library().dio_project_scan(
        _f32(pts), _u8(val), len(pts), H, W, spec.fov_up, spec.fov_down, spec.fov_left,
        spec.fov_right, _f32(image), point_index.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(mean_range))
    return image, point_index, float(mean_range.value)


class NativePairLoader:
    """Threaded batch producer over preprocessed scan and normal files.

    ``request`` batches ahead (each pair given by its first scan's flat
    index), then take them with ``next_batch``: batches come back in request
    order, whatever order the worker threads finish them in. Indices and
    batch sizes are checked here, before the library sees them."""

    def __init__(self, scan_paths: List[str], normal_paths: List[str],
                 max_points: int, n_threads: int = 4):
        if len(scan_paths) != len(normal_paths):
            raise ValueError(f"{len(scan_paths)} scan files but {len(normal_paths)} normal files")
        self._lib = library()
        self.max_points = max_points
        self._pending = collections.deque()      # the size of each batch requested
        n = self.n_scans = len(scan_paths)
        self._scan_arr = (ctypes.c_char_p * n)(*[p.encode() for p in scan_paths])
        self._norm_arr = (ctypes.c_char_p * n)(*[p.encode() for p in normal_paths])
        self._handle = self._lib.dio_loader_create(self._scan_arr, self._norm_arr, n,
                                                   max_points, n_threads)

    def request(self, first_scan_indices: np.ndarray) -> int:
        """Queue one batch of pairs -> its ticket."""
        idx = np.ascontiguousarray(first_scan_indices, dtype=np.int32)
        if idx.ndim != 1 or not len(idx) or idx.min() < 0 or idx.max() + 1 >= self.n_scans:
            raise ValueError(f"pairs must start at scans 0..{self.n_scans - 2}, got {idx}")
        ticket = int(self._lib.dio_loader_request(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(idx)))
        self._pending.append(len(idx))
        return ticket

    def next_batch(self, batch_size: int):
        """The next batch in request order (blocks until it is ready) ->
        (points_1, normals_1, valid_1, points_2, normals_2, valid_2), each
        [batch_size, max_points, ...], masks as bool."""
        if not self._pending or self._pending[0] != batch_size:
            raise ValueError(f"the next batch requested holds "
                             f"{self._pending[0] if self._pending else 'no'} pairs, not "
                             f"{batch_size}")
        self._pending.popleft()
        mp = self.max_points
        pts1, nrm1, pts2, nrm2 = (np.empty((batch_size, mp, 3), np.float32) for _ in range(4))
        val1, val2 = (np.empty((batch_size, mp), np.uint8) for _ in range(2))
        got = self._lib.dio_loader_next(self._handle, _f32(pts1), _f32(nrm1), _u8(val1),
                                        _f32(pts2), _f32(nrm2), _u8(val2))
        if got < 0:
            raise RuntimeError("native loader shut down")
        return pts1, nrm1, val1.astype(bool), pts2, nrm2, val2.astype(bool)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.dio_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
