"""The port's scan-pair dataset and loader (``delora_tpu_torch/data/
dataset.py``) against the JAX package's ``ScanPairDataset`` and
``BatchLoader`` on the same preprocessed files, and the trainer's streamed
feed against its device-resident one.

Held bit for bit: the pairs (never across sequences), truncation to
``max_points`` at load, padding, the raw and fully-cached batches, and the
epoch permutations; a streamed epoch's batches are the resident tables'
batches, and a trainer fed either way takes the same steps.
"""

import math
import os
import threading

import numpy as np
import pytest
import torch

from delora_tpu.config import load_config
from delora_tpu.data.dataset import BatchLoader as JaxBatchLoader
from delora_tpu.data.dataset import ScanPairDataset as JaxScanPairDataset
from delora_tpu.ops.projection import ProjectionSpec as JaxProjectionSpec
from delora_tpu.ops.projection_host import scan_artifacts_np as jax_scan_artifacts_np
from delora_tpu_torch.config import default_config
from delora_tpu_torch.data.dataset import BatchLoader, ScanPairDataset, epoch_permutation
from delora_tpu_torch.training.trainer import Trainer
from tests.test_torch_preprocess import overrides

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)

MAX_POINTS = 1024
SEQUENCES = {0: 5, 1: 4}          # sequence id -> scans


def write_preprocessed(root, seed=0):
    """Scans of 900-1200 points over the sensor's field of view (some above
    max_points), with unit normals, a fifth of them zero."""
    rng = np.random.default_rng(seed)
    for seq, count in SEQUENCES.items():
        base = os.path.join(root, "preprocessed", f"{seq:02d}")
        for sub in ("scans", "normals"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for k in range(count):
            n = int(rng.integers(900, 1200))
            az = rng.uniform(-math.pi, math.pi, n)
            el = rng.uniform(-0.4, 0.03, n)
            r = rng.uniform(2.0, 30.0, n)
            pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                            r * np.sin(el)], -1).astype(np.float32)
            nrm = rng.normal(size=(n, 3)).astype(np.float32)
            nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm[rng.random(n) < 0.2] = 0.0
            np.save(os.path.join(base, "scans", f"{k:06d}.npy"), pts)
            np.save(os.path.join(base, "normals", f"{k:06d}.npy"), nrm)


def dataset_overrides(root, kitti=None, **extra):
    return overrides(root, kitti={"training_identifiers": [0, 1], "max_points": MAX_POINTS,
                                  **(kitti or {})}, **extra)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset")
    write_preprocessed(str(root))
    config = default_config(dataset_overrides(root))
    ref_config = load_config(dataset_overrides(root))
    return root, ScanPairDataset(config, "kitti"), JaxScanPairDataset(ref_config, "kitti")


def test_pairs_never_cross_sequences(data):
    _, ds, ref = data
    assert ds.pairs == ref.pairs == [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2)]
    assert sum(s.nbytes + n.nbytes for s, n in ds._cache.values()) == ref.ram_cache_bytes()


def test_pairs_and_batches_equal_the_reference(data):
    _, ds, ref = data
    for i in range(len(ds)):
        ours, theirs = ds.get_pair(i), ref.get_pair(i)
        assert ours.keys() == theirs.keys()
        for key in ours:
            np.testing.assert_array_equal(ours[key], theirs[key])
        assert ours["valid_1"].sum() == min(MAX_POINTS, len(np.load(ds.scan_files[
            ours["sequence_index"]][ours["scan_index"]])))
    indices = [3, 0, 6, 4]
    for ours, theirs in zip(ds.make_batch(indices), ref.make_batch(indices)):
        np.testing.assert_array_equal(ours, theirs)
    # The reference's dataset projects with its native C++ route where the
    # library is built; its mean range sums in another order than its numpy
    # route (scan_artifacts_np), which the port copies: equal to the numpy
    # route, within one ulp of the native one.
    batch, ref_batch = ds.make_fullcached_batch(indices), ref.make_fullcached_batch(indices)
    for field in batch._fields:
        if field.startswith("mean_range"):
            np.testing.assert_allclose(getattr(batch, field), getattr(ref_batch, field),
                                       rtol=2.5e-7)
        else:
            np.testing.assert_array_equal(getattr(batch, field), getattr(ref_batch, field))
    for si, k in ds.scan_keys():
        numpy_route = jax_scan_artifacts_np(*ds.get_scan(si, k), ref._proj_spec
                                            or JaxProjectionSpec.from_config(ref.config, "kitti"),
                                            use_native=False)
        for got, want in zip(ds.scan_artifacts(si, k), numpy_route):
            np.testing.assert_array_equal(got, want)


def test_truncation_at_load_without_the_ram_cache(tmp_path):
    write_preprocessed(str(tmp_path))
    cfg = dataset_overrides(tmp_path, store_dataset_in_RAM=False,
                            kitti={"training_identifiers": [1], "max_points": 950})
    ds = ScanPairDataset(default_config(cfg), "kitti")
    ref = JaxScanPairDataset(load_config(cfg), "kitti")
    assert ds._cache == {} and len(ds) == 3
    for ours, theirs in zip(ds.make_batch([0, 1, 2]), ref.make_batch([0, 1, 2])):
        np.testing.assert_array_equal(ours, theirs)
    assert (ds.make_batch([0]).valid_1.sum(), ds.make_batch([0]).points_1.shape) == (
        950, (1, 950, 3))


@pytest.mark.parametrize("seed", [0, 7])
def test_epoch_order_equals_the_reference_loader(data, seed):
    _, ds, ref = data
    loader = BatchLoader(ds, 2, device="cpu", seed=seed)
    ref_loader = JaxBatchLoader(ref, 2, seed=seed, feed="full")
    for epoch in range(4):
        np.testing.assert_array_equal(loader.global_epoch_indices(epoch),
                                      ref_loader.global_epoch_indices(epoch))
        assert len(loader.global_epoch_indices(epoch)) // 2 == ref_loader.steps_per_epoch() == 3
    # Fewer pairs than a batch: no whole batch, so an empty epoch.
    np.testing.assert_array_equal(epoch_permutation(len(ds), 8, seed, 0),
                                  JaxBatchLoader(ref, 8, seed=seed).global_epoch_indices(0))
    assert epoch_permutation(len(ds), 8, seed, 0).size == 0


@pytest.mark.parametrize("feed", ["raw", "full"])
def test_loader_epoch_is_the_permutation_in_batches(data, feed):
    _, ds, _ = data
    loader = BatchLoader(ds, 2, device="cpu", seed=3, feed=feed, prefetch=1)
    make = ds.make_batch if feed == "raw" else ds.make_fullcached_batch
    order = loader.global_epoch_indices(5).reshape(-1, 2)
    batches = list(loader.epoch(5))
    assert len(batches) == len(order) == 3
    for batch, sel in zip(batches, order):
        for got, want in zip(batch, make(sel)):
            assert torch.is_tensor(got)
            np.testing.assert_array_equal(got.numpy(), want)


def test_abandoned_epoch_stops_its_producer(data):
    _, ds, _ = data
    before = threading.active_count()
    epoch = BatchLoader(ds, 1, device="cpu", prefetch=1).epoch(0)
    next(epoch)
    epoch.close()
    assert threading.active_count() == before


def test_producer_errors_reach_the_caller(data):
    _, ds, _ = data
    loader = BatchLoader(ds, 2, device="cpu")
    loader.dataset = type("Broken", (), {"__len__": lambda self: 7,
                                         "make_batch": lambda self, i: 1 / 0})()
    with pytest.raises(ZeroDivisionError):
        list(loader.epoch(0))


def test_streamed_feed_trains_as_the_resident_feed(data):
    """hbm_cache_scans below the scan count streams batches from the host:
    the same batches, so the same steps, losses and weights."""
    root, _, _ = data
    runs = {}
    for name, budget in (("resident", 3072), ("streamed", 4)):
        trainer = Trainer(default_config(dataset_overrides(root, hbm_cache_scans=budget)),
                          device="cpu", run_name=name)
        assert (trainer.feeds["kitti"].tables is None) == (name == "streamed")
        runs[name] = (trainer, trainer.train(2))
    (resident, h_res), (streamed, h_str) = runs["resident"], runs["streamed"]
    for a, b in zip(h_res, h_str):
        for key in a:
            if key not in ("epoch_seconds", "scan_pairs_per_sec"):
                assert a[key] == b[key], key
    for (name, p), q in zip(resident.model.named_parameters(), streamed.model.parameters()):
        assert torch.equal(p, q), name
