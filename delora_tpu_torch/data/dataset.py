"""Training-time dataset: consecutive scan pairs over preprocessed data.

The port of ``delora_tpu/data/dataset.py``'s ``ScanPairDataset`` and the
Python producer of its ``BatchLoader``:

- scans are ``<preprocessed_path>/<seq:02d>/scans/*.npy`` with row-aligned
  ``normals/*.npy`` (the preprocessing contract), for the dataset's
  ``data_identifiers``;
- a pair is (scan k, scan k + 1) of one sequence: pairs never cross
  sequences;
- with ``store_dataset_in_RAM`` the scans are held ragged (their own point
  counts) and padded to ``max_points`` only when a batch is made; every scan
  is truncated to ``max_points`` when it is loaded;
- the fully-cached and the cached-target feeds' per-scan projection
  artifacts come from ``ops/projection_host.py::scan_artifacts_np``, once a
  scan, computed up front by a thread pool (``prewarm_artifacts``);
- an epoch's pair order is ``np.random.default_rng(seed + epoch)``'s
  permutation, truncated to whole batches; a producer thread makes the
  batches ``prefetch`` ahead, and they reach the device from pinned memory
  with ``non_blocking`` copies;
- the raw feed's batches may come instead from the C++ threaded pair
  batcher (``csrc/delora_io.cpp`` through ``data/native_io.py``), which reads,
  truncates and pads the scans in its own threads without the GIL, the
  batches requested ``prefetch`` ahead and delivered in request order
  (reference dataset.py:308-345). ``native`` True always takes it (and
  raises if the library cannot be built), "auto" takes it when the RAM cache
  is off, False never. Its batches are bit for bit the Python producer's.

Under data parallelism each process (``num_shards`` of them) takes a strided
shard of every epoch's global permutation, ``perm[shard_index::num_shards]``,
and makes local batches of ``batch_size / num_shards`` pairs from it, as the
reference's per-host shards do: the union of the shards' b-th batches is the
global permutation's b-th chunk, and shard h holds its rows h, h + shards, ...
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np
import torch

from delora_tpu_torch.ops.projection import ProjectionSpec
from delora_tpu_torch.ops.projection_host import ScanArtifacts, scan_artifacts_np
from delora_tpu_torch.training.step import CachedTargetBatch, FullyCachedBatch, ScanPairBatch


def epoch_permutation(num_pairs: int, batch_size: int, seed: int, epoch: int) -> np.ndarray:
    """The epoch's pair order: ``default_rng(seed + epoch)``'s permutation,
    truncated to whole batches."""
    perm = np.random.default_rng(seed + epoch).permutation(num_pairs)
    return perm[:(num_pairs // batch_size) * batch_size]


def pad_scan(scan: np.ndarray, normals: np.ndarray, max_points: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One ragged scan (at most ``max_points`` rows) zero-padded to
    ``max_points`` -> (points [max_points, 3], normals [max_points, 3],
    validity mask)."""
    n = len(scan)
    pts = np.zeros((max_points, 3), np.float32)
    nrm = np.zeros((max_points, 3), np.float32)
    msk = np.zeros(max_points, bool)
    pts[:n] = scan[:, :3]
    nrm[:n] = normals[:, :3]
    msk[:n] = True
    return pts, nrm, msk


class ScanPairDataset:
    """Index over consecutive scan pairs of one dataset's sequences."""

    def __init__(self, config, dataset: str):
        self.config = config
        self.dataset = dataset
        spec = config[dataset]
        self.max_points = int(spec["max_points"])
        self.scan_files: List[List[str]] = []
        self.normal_files: List[List[str]] = []
        self.sequence_ids: List[int] = list(spec["data_identifiers"])
        for seq in self.sequence_ids:
            base = os.path.join(spec["preprocessed_path"], format(seq, "02d"))
            scans = sorted(glob.glob(os.path.join(base, "scans", "*.npy")))
            normals = sorted(glob.glob(os.path.join(base, "normals", "*.npy")))
            if not scans:
                raise FileNotFoundError(f"No preprocessed scans under {base}")
            if len(scans) != len(normals):
                raise ValueError(f"scans/normals count mismatch under {base}")
            self.scan_files.append(scans)
            self.normal_files.append(normals)

        # (sequence_index, scan_index) of each pair's first scan.
        self.pairs: List[Tuple[int, int]] = [
            (si, k) for si, scans in enumerate(self.scan_files) for k in range(len(scans) - 1)]
        self._proj_spec = ProjectionSpec.from_config(config, dataset)
        self._artifacts: Dict[Tuple[int, int], ScanArtifacts] = {}
        self._cache: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        self.cache_in_ram = bool(config.get("store_dataset_in_RAM", True))
        if self.cache_in_ram:
            for key in self.scan_keys():
                self._cache[key] = self._load_ragged(*key)

    def __len__(self) -> int:
        return len(self.pairs)

    def scan_keys(self) -> List[Tuple[int, int]]:
        """(sequence_index, scan_index) of every scan, in sequence order."""
        return [(si, k) for si, scans in enumerate(self.scan_files) for k in range(len(scans))]

    def _load_ragged(self, seq_index: int, scan_index: int):
        scan = np.load(self.scan_files[seq_index][scan_index]).astype(np.float32)
        normals = np.load(self.normal_files[seq_index][scan_index]).astype(np.float32)
        n = min(len(scan), self.max_points)
        return scan[:n], normals[:n]

    def get_scan(self, seq_index: int, scan_index: int):
        """One scan, padded -> (points, normals, valid) (see :func:`pad_scan`)."""
        ragged = self._cache.get((seq_index, scan_index))
        if ragged is None:
            ragged = self._load_ragged(seq_index, scan_index)
        return pad_scan(*ragged, self.max_points)

    def get_pair(self, index: int) -> dict:
        """-> the pair's padded arrays and its (sequence_index, scan_index)."""
        si, k = self.pairs[index]
        p1, n1, m1 = self.get_scan(si, k)
        p2, n2, m2 = self.get_scan(si, k + 1)
        return {"points_1": p1, "normals_1": n1, "valid_1": m1,
                "points_2": p2, "normals_2": n2, "valid_2": m2,
                "sequence_index": si, "scan_index": k}

    def make_batch(self, indices) -> ScanPairBatch:
        """The raw feed's batch of the pairs ``indices``, as numpy arrays."""
        items = [self.get_pair(int(i)) for i in indices]
        return ScanPairBatch(*(np.stack([it[f] for it in items]) for f in ScanPairBatch._fields))

    def scan_artifacts(self, seq_index: int, scan_index: int) -> ScanArtifacts:
        """The scan's projection artifacts (both pair roles), computed once."""
        key = (seq_index, scan_index)
        cached = self._artifacts.get(key)
        if cached is None:
            cached = scan_artifacts_np(*self.get_scan(*key), self._proj_spec)
            self._artifacts[key] = cached
        return cached

    def prewarm_artifacts(self, num_threads: int = 8) -> int:
        """Compute every scan's artifacts up front on ``num_threads`` threads
        -> the number computed."""
        todo = [key for key in self.scan_keys() if key not in self._artifacts]
        with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
            for _ in pool.map(lambda key: self.scan_artifacts(*key), todo):
                pass
        return len(todo)

    def make_cached_batch(self, indices) -> CachedTargetBatch:
        """The cached-target feed's batch of the pairs ``indices``, as numpy
        arrays: scan k's target artifacts and scan k + 1 padded."""
        rows = []
        for i in indices:
            si, k = self.pairs[int(i)]
            tgt = self.scan_artifacts(si, k)
            rows.append((tgt.image, tgt.normal_image, tgt.mean_range, *self.get_scan(si, k + 1)))
        image, normal_image, mean_range, points, normals, valid = zip(*rows)
        return CachedTargetBatch(np.stack(image), np.stack(normal_image),
                                 np.asarray(mean_range, np.float32), np.stack(points),
                                 np.stack(normals), np.stack(valid))

    def make_fullcached_batch(self, indices) -> FullyCachedBatch:
        """The fully-cached feed's batch of the pairs ``indices``, as numpy
        arrays: scan k is the target, scan k + 1 the source."""
        tgt, src = [], []
        for i in indices:
            si, k = self.pairs[int(i)]
            tgt.append(self.scan_artifacts(si, k))
            src.append(self.scan_artifacts(si, k + 1))
        return FullyCachedBatch(
            image_1=np.stack([a.image for a in tgt]),
            normal_image_1=np.stack([a.normal_image for a in tgt]),
            mean_range_1=np.asarray([a.mean_range for a in tgt], np.float32),
            image_2=np.stack([a.image for a in src]),
            src_points=np.stack([a.src_points for a in src]),
            src_normals=np.stack([a.src_normals for a in src]),
            src_valid=np.stack([a.src_valid for a in src]),
            mean_range_2=np.asarray([a.mean_range for a in src], np.float32))


Batch = Union[ScanPairBatch, CachedTargetBatch, FullyCachedBatch]


def batch_to_device(batch: Batch, device: torch.device) -> Batch:
    """A numpy batch as tensors on ``device``."""
    return type(batch)(*(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in batch))


class BatchLoader:
    """Shuffled, epoch-based whole batches of a :class:`ScanPairDataset` with a
    background producer: ``feed`` "raw" gives :class:`ScanPairBatch`,
    "cached" :class:`CachedTargetBatch` and "full" :class:`FullyCachedBatch`,
    on ``device``. ``native`` (True, "auto" or False) chooses the raw feed's
    C++ batcher (see the module docstring); ``use_native`` says whether it
    was taken. ``batch_size`` is the global batch; shard ``shard_index`` of
    ``num_shards`` gets ``local_batch`` pairs of each (see the module
    docstring)."""

    def __init__(self, dataset: ScanPairDataset, batch_size: int, *, device: torch.device,
                 seed: int = 0, prefetch: int = 2, feed: str = "raw",
                 native: Union[bool, str] = "auto", num_shards: int = 1,
                 shard_index: int = 0):
        if batch_size % num_shards != 0:
            raise ValueError(f"batch_size {batch_size} must divide evenly across "
                             f"{num_shards} shards")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside 0..{num_shards - 1}")
        if feed not in ("raw", "cached", "full"):
            raise ValueError(f"unknown feed mode {feed!r}")
        if native not in ("auto", True, False):
            raise ValueError(f"native must be 'auto', True or False, got {native!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.local_batch = batch_size // num_shards
        self.device = torch.device(device)
        self.seed = seed
        self.prefetch = prefetch
        self.feed = feed
        self._native_loader = None
        self._pair_first_flat = None
        self.use_native = feed == "raw" and (
            native is True or (native == "auto" and not dataset.cache_in_ram))
        if self.use_native:
            from delora_tpu_torch.data.native_io import library

            library()                       # built now; raises if it cannot be

    def global_epoch_indices(self, epoch: int) -> np.ndarray:
        """The epoch's pair order over all shards (see
        :func:`epoch_permutation`), the same in every process."""
        return epoch_permutation(len(self.dataset), self.batch_size, self.seed, epoch)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This shard's pairs of the epoch, in order: the strided slice of
        the global order."""
        return self.global_epoch_indices(epoch)[self.shard_index::self.num_shards]

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """This shard's batches of the epoch on the device. A producer thread
        makes them (``prefetch`` wait in its queue) while the caller's steps
        run; an error in the producer is raised to the caller."""
        indices = self.epoch_indices(epoch)
        B = self.local_batch
        n_batches = len(indices) // B
        if self.use_native:
            yield from self._native_epoch(indices, n_batches)
            return
        make = getattr(self.dataset, {"raw": "make_batch", "cached": "make_cached_batch",
                                      "full": "make_fullcached_batch"}[self.feed])
        pin = self.device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def put(item) -> None:
            # Gives up once the consumer has gone (the epoch was abandoned).
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    batch = make(indices[b * B:(b + 1) * B])
                    tensors = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in batch)
                    if pin:
                        tensors = tuple(t.pin_memory() for t in tensors)
                    put((type(batch), tensors))
            except Exception as e:              # handed to the consumer, which raises it
                put(e)
            else:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                kind, tensors = item
                yield kind(*(t.to(self.device, non_blocking=pin) for t in tensors))
        finally:
            stop.set()
            thread.join(timeout=10.0)

    def _native_epoch(self, indices: np.ndarray, n_batches: int) -> Iterator[ScanPairBatch]:
        """The raw feed's epoch through the C++ pair batcher: batches are
        requested ``prefetch`` ahead and come back in request order; an
        abandoned epoch takes back what it requested, so the next epoch
        starts clean."""
        from delora_tpu_torch.data.native_io import NativePairLoader

        ds = self.dataset
        if self._native_loader is None:
            offsets = np.cumsum([0] + [len(s) for s in ds.scan_files[:-1]])
            self._pair_first_flat = np.asarray([offsets[si] + k for si, k in ds.pairs],
                                               np.int32)
            self._native_loader = NativePairLoader(
                [p for seq in ds.scan_files for p in seq],
                [p for seq in ds.normal_files for p in seq],
                ds.max_points, n_threads=max(2, self.prefetch))
        loader, flat, B = self._native_loader, self._pair_first_flat, self.local_batch
        requested = delivered = 0

        def request() -> None:
            nonlocal requested
            loader.request(flat[indices[requested * B:(requested + 1) * B]])
            requested += 1

        try:
            while requested < min(max(1, self.prefetch), n_batches):
                request()
            while delivered < n_batches:
                arrays = loader.next_batch(B)
                delivered += 1
                if requested < n_batches:
                    request()
                yield ScanPairBatch(*(torch.from_numpy(a).to(self.device) for a in arrays))
        finally:
            for _ in range(requested - delivered):
                loader.next_batch(B)
