"""The port's host IO runtime (``csrc/delora_io.cpp`` through
``delora_tpu_torch/data/native_io.py``), built here by the host compiler.

Held: the readers bit-equal to numpy; the C++ projection against the port's
numpy route at the limits the JAX package holds its own to
(``tests/test_native_io.py``: under 0.1% of winners apart, agreeing pixels
within 1e-6, the mean range within 1e-5 relative); the loader's raw-feed
batches bit-equal to the Python producer's (the port's and the JAX
package's); and batches in request order when a later, smaller request
finishes first. Every call that waits on the batcher runs in a thread
joined with a 30 s timeout, so an ordering fault fails the test instead of
hanging it. The JAX package's own library is never loaded here.
"""

import math
import threading

import numpy as np
import pytest
import torch

from delora_tpu_torch.config import default_config
from delora_tpu_torch.data import native_io
from delora_tpu_torch.data.dataset import BatchLoader, ScanPairDataset
from delora_tpu_torch.ops.projection import ProjectionSpec
from delora_tpu_torch.ops.projection_host import project_scan_np

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)

WAIT_S = 30.0


def bounded(fn, *args):
    """``fn(*args)`` in a thread joined within WAIT_S seconds."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:          # handed to the test's thread
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(WAIT_S)
    if thread.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} did not return within {WAIT_S:.0f} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def test_velodyne_reader_matches_numpy(tmp_path):
    data = np.random.default_rng(0).normal(size=(1000, 4)).astype(np.float32)
    path = str(tmp_path / "000000.bin")
    data.tofile(path)
    np.testing.assert_array_equal(native_io.read_velodyne_native(path), data)
    np.testing.assert_array_equal(native_io.read_velodyne_native(path, capacity=17), data[:17])


@pytest.mark.parametrize("capacity", [1000, 40])
def test_npy_reader_matches_numpy(tmp_path, capacity):
    data = np.random.default_rng(1).normal(size=(321, 3)).astype(np.float32)
    path = str(tmp_path / "a.npy")
    np.save(path, data)
    np.testing.assert_array_equal(native_io.read_npy_native(path, capacity), data[:capacity])


def test_npy_reader_refuses_other_layouts(tmp_path):
    path = str(tmp_path / "b.npy")
    np.save(path, np.zeros((5, 3), np.float64))
    with pytest.raises(IOError):
        native_io.read_npy_native(path, 10)


def test_projection_matches_the_numpy_route():
    """``dio_project_scan`` (scatter-min) against ``project_scan_np`` (the
    stable sorts the port's artifacts use): the winners, the image and the
    mean range at the JAX package's limits for its own native route."""
    rng = np.random.default_rng(11)
    n = 20000
    pts = (rng.standard_normal((n, 3)) * np.array([12.0, 12.0, 1.0])).astype(np.float32)
    pts[:, 2] -= 1.6
    valid = rng.random(n) > 0.05
    spec = ProjectionSpec(height=32, width=360, fov_up=math.radians(2.0),
                          fov_down=math.radians(-24.5), fov_left=math.radians(-179.9),
                          fov_right=math.radians(179.9))
    ref = project_scan_np(pts, valid, spec)
    image, point_index, mean_range = native_io.project_scan_native(pts, valid, spec)
    assert (point_index != ref.point_index).mean() < 1e-3
    agree = point_index == ref.point_index
    np.testing.assert_allclose(image[agree], ref.image[agree], rtol=1e-6, atol=1e-6)
    assert mean_range == pytest.approx(ref.mean_range, rel=1e-5)


def write_pairs(root, sizes, seed=2):
    rng = np.random.default_rng(seed)
    scans, normals, raw = [], [], []
    for i, n in enumerate(sizes):
        s = rng.normal(size=(n, 3)).astype(np.float32)
        m = rng.normal(size=(n, 3)).astype(np.float32)
        scans.append(str(root / f"s{i}.npy"))
        normals.append(str(root / f"n{i}.npy"))
        np.save(scans[-1], s)
        np.save(normals[-1], m)
        raw.append((s, m))
    return scans, normals, raw


def test_pair_loader_batches(tmp_path):
    scans, normals, raw = write_pairs(tmp_path, [50 + 10 * i for i in range(6)])
    loader = native_io.NativePairLoader(scans, normals, max_points=128, n_threads=2)
    assert loader.request(np.array([0, 2])) == 0
    assert loader.request(np.array([4])) == 1
    pts1, nrm1, val1, pts2, nrm2, val2 = bounded(loader.next_batch, 2)
    assert pts1.shape == (2, 128, 3) and val1.dtype == bool
    np.testing.assert_array_equal(pts1[0][:50], raw[0][0])
    np.testing.assert_array_equal(pts2[0][:60], raw[1][0])
    np.testing.assert_array_equal(nrm1[1][:70], raw[2][1])
    np.testing.assert_array_equal(nrm2[1][:80], raw[3][1])
    assert val1[0].sum() == 50 and val2[0].sum() == 60 and not pts1[0][50:].any()
    with pytest.raises(ValueError, match="holds 1 pairs"):
        loader.next_batch(2)                     # never a copy past the buffers
    p1, _, v1, _, _, v2 = bounded(loader.next_batch, 1)
    np.testing.assert_array_equal(p1[0][:90], raw[4][0])
    assert v1[0].sum() == 90 and v2[0].sum() == 100
    for bad in ([5], [-1], []):                  # scan 5 has no successor
        with pytest.raises(ValueError):
            loader.request(np.array(bad, np.int64))
    with pytest.raises(ValueError, match="holds no pairs"):
        loader.next_batch(1)
    loader.close()


def test_later_smaller_request_finishing_first_keeps_request_order(tmp_path):
    """A large batch, then a one-pair batch, repeated, on two workers: the
    small one usually finishes first. Each batch comes back as requested
    (the original batcher's FIFO of finished batches waited here forever)."""
    sizes = [60000] * 9 + [10, 12]
    scans, normals, raw = write_pairs(tmp_path, sizes)
    loader = native_io.NativePairLoader(scans, normals, max_points=60000, n_threads=2)
    large, small = np.arange(8), np.array([9])
    for _ in range(4):
        loader.request(large)
        loader.request(small)
    for _ in range(4):
        p1, _, v1, p2, _, v2 = bounded(loader.next_batch, 8)
        for b in range(8):
            np.testing.assert_array_equal(p1[b], raw[b][0])
            np.testing.assert_array_equal(p2[b], raw[b + 1][0])
        assert v1.all() and v2.all()
        p1, _, v1, p2, _, v2 = bounded(loader.next_batch, 1)
        np.testing.assert_array_equal(p1[0][:10], raw[9][0])
        np.testing.assert_array_equal(p2[0][:12], raw[10][0])
        assert (v1.sum(), v2.sum()) == (10, 12)
    loader.close()


def write_preprocessed(root, counts=(6, 4), seed=3):
    """Preprocessed sequences of 40-120 points a scan (some above the
    loader's max_points), with normals."""
    rng = np.random.default_rng(seed)
    for seq, count in enumerate(counts):
        base = root / "pre" / f"{seq:02d}"
        (base / "scans").mkdir(parents=True)
        (base / "normals").mkdir(parents=True)
        for i in range(count):
            n = int(rng.integers(40, 120))
            np.save(base / "scans" / f"{i:06d}.npy", rng.normal(size=(n, 3)).astype(np.float32))
            np.save(base / "normals" / f"{i:06d}.npy",
                    rng.normal(size=(n, 3)).astype(np.float32))


def loader_config(root, ram):
    return default_config({"kitti": {"preprocessed_path": str(root / "pre"),
                                      "training_identifiers": [0, 1], "max_points": 64},
                           "store_dataset_in_RAM": ram})


def drain(loader, epoch):
    """An epoch's batches, each waited on for at most WAIT_S seconds."""
    epoch_iter = loader.epoch(epoch)
    batches = []
    while True:
        batch = bounded(next, epoch_iter, None)
        if batch is None:
            return batches
        batches.append(batch)


@pytest.mark.parametrize("epoch", [0, 3])
def test_batch_loader_native_batches_equal_the_python_producer(tmp_path, epoch):
    """The raw feed through the C++ batcher: bit for bit the port's Python
    producer's batches and the JAX package's, truncation at max_points
    included, pairs never across sequences."""
    from delora_tpu.config import load_config
    from delora_tpu.data.dataset import BatchLoader as JaxBatchLoader
    from delora_tpu.data.dataset import ScanPairDataset as JaxScanPairDataset

    write_preprocessed(tmp_path)
    ds = ScanPairDataset(loader_config(tmp_path, ram=False), "kitti")
    native = BatchLoader(ds, 2, device="cpu", seed=7, native=True)
    python = BatchLoader(ds, 2, device="cpu", seed=7, native=False)
    nb, pb = drain(native, epoch), drain(python, epoch)
    assert native.use_native and native._native_loader is not None and not python.use_native
    assert len(nb) == len(pb) == 4
    ref_ds = JaxScanPairDataset(load_config({"kitti": {
        "preprocessed_path": str(tmp_path / "pre"), "training_identifiers": [0, 1],
        "max_points": 64}, "store_dataset_in_RAM": False}), "kitti")
    jb = list(JaxBatchLoader(ref_ds, 2, seed=7, native=False).epoch(epoch))
    for a, b, c in zip(nb, pb, jb):
        for fa, fb, fc in zip(a, b, c):
            assert fa.dtype == fb.dtype
            assert torch.equal(fa, fb)
            np.testing.assert_array_equal(fa.numpy(), fc)
    native._native_loader.close()


def test_native_choice_follows_the_reference(tmp_path):
    """"auto" takes the batcher for the raw feed without the RAM cache, never
    for the cached feeds; False never takes it."""
    write_preprocessed(tmp_path)
    disk = ScanPairDataset(loader_config(tmp_path, ram=False), "kitti")
    ram = ScanPairDataset(loader_config(tmp_path, ram=True), "kitti")
    assert BatchLoader(disk, 2, device="cpu").use_native
    assert not BatchLoader(ram, 2, device="cpu").use_native
    assert not BatchLoader(disk, 2, device="cpu", native=False).use_native
    assert not BatchLoader(disk, 2, device="cpu", feed="full", native=True).use_native
    assert BatchLoader(ram, 2, device="cpu", native=True).use_native
    with pytest.raises(ValueError):
        BatchLoader(disk, 2, device="cpu", native="yes")


def test_abandoned_native_epoch_leaves_the_next_one_clean(tmp_path):
    write_preprocessed(tmp_path)
    ds = ScanPairDataset(loader_config(tmp_path, ram=False), "kitti")
    loader = BatchLoader(ds, 2, device="cpu", seed=1, native=True, prefetch=3)
    epoch = loader.epoch(0)
    bounded(next, epoch)
    bounded(epoch.close)
    again = drain(loader, 0)
    ref = drain(BatchLoader(ds, 2, device="cpu", seed=1, native=False), 0)
    for a, b in zip(again, ref):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_failed_build_raises(monkeypatch):
    """``native_io: true`` never runs without its library: a build that
    fails raises."""
    from delora_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build, "library_path",
                        lambda name: build.BUILD_DIR / "libmissing-0.so")
    monkeypatch.setattr(build, "source_path", lambda name: build.CSRC_DIR / "missing.cpp")
    native_io.library.cache_clear()
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build of missing.cpp failed"):
            native_io.library()
    finally:
        native_io.library.cache_clear()
        build.load_library.cache_clear()


def test_trainer_streams_the_raw_feed_through_the_batcher(tmp_path):
    """``native_io: true`` on the raw feed from disk: the trainer's loader
    takes the batcher, and an epoch takes the Python producer's steps bit
    for bit."""
    from tests.test_torch_dataset import dataset_overrides
    from tests.test_torch_dataset import write_preprocessed as write_dataset
    from delora_tpu_torch.training.trainer import Trainer

    write_dataset(str(tmp_path))
    runs = {}
    for native in (True, False):
        config = default_config(dataset_overrides(
            tmp_path, native_io=native, cache_target_projections=False,
            store_dataset_in_RAM=False, checkpoint_dir=str(tmp_path / f"ckpt_{native}")))
        trainer = Trainer(config, device="cpu", run_name=f"native_{native}")
        assert trainer.feed == "raw" and trainer.feeds["kitti"].loader.use_native == native
        runs[native] = bounded(trainer.train_epoch, 0)
    for key, value in runs[False].items():
        if key not in ("epoch_seconds", "scan_pairs_per_sec"):
            assert runs[True][key] == value, key
