"""Data-parallel training over ``torch.distributed`` (``delora_tpu_torch/
parallel/``) on the CPU, two gloo processes against one process.

- ``BatchLoader`` shards: each shard's epoch order is bit-equal to the JAX
  ``BatchLoader``'s with the same ``num_shards`` and ``shard_index``, the
  shards' b-th batches together are the global order's b-th chunk, and a
  shard's batches are the JAX loader's, from the Python producer and from the
  C++ batcher alike.
- One step (``training/step.py::train_step`` with ``StepConfig.shard``) in
  two processes, each on its rows of a global batch of 4 pairs, against the
  same step without a shard on the whole batch in this process, from the same seeded
  weights and generators: the metrics within rtol 1e-5, the gradients within
  rtol 1e-5 (atol 1e-5 of the tensor's largest gradient, for elements that
  cancel), the augmentation rotations and the dropout masks bit-equal to the
  one process's rows, and the two processes' weights after the step
  bit-equal. The cases cover the fully-cached, cached-target and raw feeds,
  brute correspondence, ``quaternion_normalization: global``, augmentation,
  dropout and the EMA.
- The disk trainer through ``parallel/multiprocess.py`` on the drive and
  settings of ``tests/test_torch_trainer_disk.py`` (B = 2), from the JAX
  ``Trainer``'s initial weights: 2 epochs on tables split over the processes,
  then a resume from ``latest`` on every process for one epoch streamed from
  the host, in 1 and in 2 processes. Both processes' losses are identical,
  within rtol 1e-5 of the one process's and within rtol 1e-4 of the JAX
  ``Trainer``'s three epochs (that file's tolerance); process 0 alone wrote
  the checkpoints, and both resumed with the saved weights.

Every process started here is joined within 300 s (``run_group`` kills the
group and raises past it). The file takes about 55 s on one worker.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from delora_tpu_torch.config import default_config, training_feed
from delora_tpu_torch.parallel.multiprocess import compare, run_group

# One intra-op thread: the suite runs several pytest workers on the CPU's
# cores, and larger OpenMP teams in each would spin against one another.
torch.set_num_threads(1)

TIMEOUT = 300.0
B_GLOBAL = 4
STEP_BASE = {"kitti": {"max_points": 1024, "vertical_cells": 8, "horizontal_cells": 32},
             "resnet_outputs": 8, "layers": [1, 1, 1, 1], "factor_fewer_resnet_channels": 16,
             "compute_dtype": "float32", "batch_size": B_GLOBAL, "learning_rate": 0.01}
STEP_CASES = {
    "full": {},
    "full-global-dropout": {"quaternion_normalization": "global", "use_dropout": True},
    "full-augment-recipe": {"random_point_cloud_rotations": True, "soft_match_sigma": 0.3,
                            "lambda_reverse_po2pl": 1.0, "ema_decay": 0.9},
    "cached-augment": {"cache_source_projections": False,
                       "random_point_cloud_rotations": True},
    "raw-global-augment-dropout": {"cache_target_projections": False,
                                   "quaternion_normalization": "global",
                                   "random_point_cloud_rotations": True, "use_dropout": True},
    "raw-brute": {"correspondence": "brute"},
    "cached-projective": {"cache_source_projections": False, "correspondence": "projective"},
}


def scans(n, seed=0, points=600):
    """Random scans over the sensor's field of view with unit normals (a
    fifth of them zero)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        az = rng.uniform(-np.pi, np.pi, points)
        el = rng.uniform(-0.4, 0.03, points)
        r = rng.uniform(2.0, 30.0, points)
        pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                        r * np.sin(el)], -1).astype(np.float32)
        nrm = rng.normal(size=(points, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm[rng.random(points) < 0.2] = 0.0
        out.append((pts, nrm))
    return out


def build_case(name):
    """Everything a step of case ``name`` needs, made the same way in every
    process: (model, optimizer, schedule, EMA, dropout generator, augment
    generator, step config, the global batch as numpy arrays)."""
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.ops.projection import ProjectionSpec
    from delora_tpu_torch.ops.projection_host import scan_artifacts_np
    from delora_tpu_torch.training.state import make_optimizer, make_param_ema
    from delora_tpu_torch.training.step import StepConfig
    from delora_tpu_torch.training.trainer import BATCH_LEAVES, padded_scan

    config = default_config({**STEP_BASE, **STEP_CASES[name]})
    feed = training_feed(config)
    spec = ProjectionSpec.from_config(config)
    rows = []
    for p, n in scans(B_GLOBAL + 1):
        padded = padded_scan(p, n, config["kitti"]["max_points"])
        if feed == "raw":
            rows.append(padded)
        elif feed == "full":
            rows.append(tuple(scan_artifacts_np(*padded, spec)))
        else:
            a = scan_artifacts_np(*padded, spec)
            rows.append((a.image, a.normal_image, a.mean_range, *padded))
    leaves = [np.stack([np.asarray(r[i]) for r in rows]) for i in range(len(rows[0]))]
    leaves = [x.astype(np.float32) if x.dtype == np.float64 else x for x in leaves]
    tgt_leaves, src_leaves, kind = BATCH_LEAVES[feed]
    tgt, src = np.arange(B_GLOBAL), np.arange(1, B_GLOBAL + 1)
    batch = kind(*(leaves[i][tgt] for i in tgt_leaves), *(leaves[i][src] for i in src_leaves))
    model = OdometryModel(ModelConfig.from_config(config), torch.Generator().manual_seed(0))
    model.train()
    optimizer, schedule = make_optimizer(config, model.parameters(), B_GLOBAL)
    ema = make_param_ema(config, model)
    dgen = torch.Generator().manual_seed(1) if config["use_dropout"] else None
    agen = torch.Generator().manual_seed(2) if config["random_point_cloud_rotations"] else None
    cfg = StepConfig.from_config(config, supervised=False)
    return model, optimizer, schedule, ema, dgen, agen, cfg, batch


def traced_step(name, shard=None):
    """One step of case ``name`` on the global batch (``shard`` None, this
    process) or on rows ``shard[0]::shard[1]`` of it (a group's process) ->
    its metrics, gradients, weights after the step, EMA, and the
    augmentation rotations and dropout masks it drew."""
    from delora_tpu_torch.models import resnet
    from delora_tpu_torch.parallel.dist import BatchShard
    from delora_tpu_torch.training import step as tstep

    model, optimizer, schedule, ema, dgen, agen, cfg, batch = build_case(name)
    if shard is not None:
        batch = type(batch)(*(x[shard[0]::shard[1]] for x in batch))
        cfg = cfg._replace(shard=BatchShard(*shard))
    batch = type(batch)(*map(torch.from_numpy, batch))
    rotations, dropped = [], []
    augment, dropout = tstep._augment, resnet.dropout

    def record_augment(points, normals, rot):
        rotations.append(rot.detach().clone())
        return augment(points, normals, rot)

    def record_dropout(x, *args, **kw):
        out = dropout(x, *args, **kw)
        dropped.append(((out == 0) & (x != 0)).detach().clone())
        return out

    tstep._augment, resnet.dropout = record_augment, record_dropout
    try:
        metrics = tstep.train_step(model, optimizer, batch, cfg, schedule, ema, dgen, agen)
    finally:
        tstep._augment, resnet.dropout = augment, dropout
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": [p.grad.numpy().copy() for p in model.parameters()],
            "params": {k: v.numpy().copy() for k, v in model.state_dict().items()},
            "ema": None if ema is None else [p.numpy().copy() for p in ema.params],
            "rotations": [r.numpy() for r in rotations],
            "dropped": [d.numpy() for d in dropped]}


def group_worker(device, names):
    """A group's process: :func:`traced_step` of each case on its rows, and
    :func:`tables_worker`."""
    import torch.distributed as dist

    shard = (dist.get_rank(), dist.get_world_size())
    out = {name: traced_step(name, shard) for name in names}
    out["tables"] = tables_worker(device)
    out["infer"] = infer_rows(shard)
    return out


def infer_rows(shard=None):
    """``parallel/step.py::infer_step`` of the raw case's weights on rows
    ``shard[0]::shard[1]`` of its global batch (all of it without a
    shard)."""
    from delora_tpu_torch.parallel.step import infer_step

    model, _, _, _, _, _, cfg, batch = build_case("raw-brute")
    if shard is not None:
        batch = type(batch)(*(x[shard[0]::shard[1]] for x in batch))
    return infer_step(model, type(batch)(*map(torch.from_numpy, batch)), cfg).numpy()


@pytest.fixture(scope="module")
def two_process_steps(tmp_path_factory):
    return run_group("tests.test_torch_distributed:group_worker", 2,
                     {"names": sorted(STEP_CASES)}, workdir=str(tmp_path_factory.mktemp("steps")),
                     device="cpu", backend="gloo", timeout=TIMEOUT, threads=1)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_two_process_step_equals_one_process(two_process_steps, name):
    want = traced_step(name)
    got = [r[name] for r in two_process_steps]
    for key, value in want["metrics"].items():
        for rank in range(2):
            np.testing.assert_allclose(got[rank]["metrics"][key], value, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} {key} rank {rank}")
    for rank in range(2):
        for g, w in zip(got[rank]["grads"], want["grads"]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
        # The draws for the global batch, each process keeping its rows.
        assert len(got[rank]["rotations"]) == len(want["rotations"])
        for r, w in zip(got[rank]["rotations"], want["rotations"]):
            np.testing.assert_array_equal(r, w[rank::2])
        assert len(got[rank]["dropped"]) == len(want["dropped"])
        for d, w in zip(got[rank]["dropped"], want["dropped"]):
            np.testing.assert_array_equal(d, w[rank::2])
    for key in want["params"]:
        np.testing.assert_array_equal(got[0]["params"][key], got[1]["params"][key])
    if want["ema"] is not None:
        for a, b in zip(got[0]["ema"], got[1]["ema"]):
            np.testing.assert_array_equal(a, b)
    config = default_config({**STEP_BASE, **STEP_CASES[name]})
    assert bool(want["rotations"]) == config["random_point_cloud_rotations"]
    assert bool(want["dropped"]) == config["use_dropout"]


def test_sharded_tables_gather_the_rows_each_process_needs(two_process_steps):
    """``ShardedTables`` over 2 processes: rows spread over both blocks,
    repeated and in any order, come back as the full table's rows, for
    float, integer and boolean leaves."""
    table = tables_fixture()
    for rank, result in enumerate(two_process_steps):
        got, rows = result["tables"], TABLE_NEEDS[rank]
        for leaf, want in zip(got, (table[0][rows], table[1][rows], table[2][rows])):
            np.testing.assert_array_equal(leaf, want)


def test_each_process_infers_its_rows(two_process_steps):
    want = infer_rows()
    for rank, result in enumerate(two_process_steps):
        np.testing.assert_allclose(result["infer"], want[rank::2], rtol=1e-5, atol=1e-6)


TABLE_NEEDS = ([6, 0, 6, 3], [1, 5, 2])


def tables_fixture():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(7, 2, 3)).astype(np.float32), rng.integers(0, 9, 7),
            rng.random(7) < 0.5)


def tables_worker(device):
    from delora_tpu_torch.parallel.step import ShardedTables

    tables = ShardedTables(tables_fixture(), device)
    assert tables.per == 4 and tables.local[0].shape == (4, 2, 3)
    return [t.numpy() for t in tables.gather(TABLE_NEEDS, (0, 1, 2))]


# ---- the loader's shards ------------------------------------------------------


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    from tests.test_torch_dataset import write_preprocessed

    root = tmp_path_factory.mktemp("dist_dataset")
    write_preprocessed(str(root))
    return root


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_loader_shards_equal_the_jax_loader(dataset_root, native):
    from delora_tpu.config import load_config
    from delora_tpu.data.dataset import BatchLoader as JaxBatchLoader
    from delora_tpu.data.dataset import ScanPairDataset as JaxScanPairDataset
    from delora_tpu_torch.data.dataset import BatchLoader, ScanPairDataset
    from tests.test_torch_dataset import dataset_overrides

    B, local = 2, 1
    overrides = dataset_overrides(dataset_root, batch_size=B, store_dataset_in_RAM=False)
    ds = ScanPairDataset(default_config(overrides), "kitti")
    ref_ds = JaxScanPairDataset(load_config(overrides), "kitti")
    shards = [BatchLoader(ds, B, device="cpu", seed=5, num_shards=2, shard_index=h,
                          native=native) for h in range(2)]
    refs = [JaxBatchLoader(ref_ds, B, seed=5, num_shards=2, shard_index=h, native=False)
            for h in range(2)]
    assert all(s.use_native == native and s.local_batch == local for s in shards)
    for epoch in (0, 3):
        order = shards[0].global_epoch_indices(epoch)
        assert len(order) == 6
        for shard, ref in zip(shards, refs):
            np.testing.assert_array_equal(shard.epoch_indices(epoch), ref.epoch_indices(epoch))
        for b in range(len(order) // B):
            together = np.concatenate([s.epoch_indices(epoch)[local * b:local * (b + 1)]
                                       for s in shards])
            assert sorted(together) == sorted(order[B * b:B * (b + 1)])
        for shard, ref in zip(shards, refs):
            ours, theirs = list(shard.epoch(epoch)), list(ref.epoch(epoch))
            assert len(ours) == len(theirs) == len(order) // B
            for a, b in zip(ours, theirs):
                assert a[0].shape[0] == local
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    with pytest.raises(ValueError):
        BatchLoader(ds, 3, device="cpu", num_shards=2, shard_index=0)


# ---- the disk trainer in 1 and 2 processes ----------------------------------


def test_two_process_disk_trainer_matches_one_and_the_jax_trainer(dataset_root, tmp_path):
    import jax

    from delora_tpu.config import load_config
    from delora_tpu.training.trainer import Trainer as JaxTrainer
    from delora_tpu_torch.utils.params import params_from_jax
    from tests.test_torch_dataset import dataset_overrides

    ref = JaxTrainer(load_config(dataset_overrides(
        dataset_root, checkpoint_dir=str(tmp_path / "jax_ckpt"),
        log_dir=str(tmp_path / "jax_runs"))), run_name="jax")
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, ref.state.params)).items()}
    config = default_config(dataset_overrides(
        dataset_root, checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs")))
    # The port's processes run while the JAX trainer compiles and trains.
    with ThreadPoolExecutor(1) as pool:
        runs = pool.submit(compare, config, str(tmp_path / "work"), 2, device="cpu",
                           backend="gloo", epochs=2, rtol=1e-5, timeout=TIMEOUT, threads=1,
                           init_weights=init)
        want = [ref.train_epoch(epoch) for epoch in range(3)]
        verdict = runs.result(timeout=2 * TIMEOUT + 60)
    assert verdict["ok"] and verdict["max_rel_drift"] <= 1e-5
    for n, results in verdict["runs"].items():
        assert [r["rank"] for r in results] == list(range(n))
        assert all(r["resident"] and r["streamed"] for r in results)
        assert results[0]["writes"] == 3 and all(r["writes"] == 0 for r in results[1:])
        assert results[0]["checkpoint_files"] == ["epoch_00000", "latest"]
        for got in results:
            for epoch, (g, w) in enumerate(zip(got["metrics"], want)):
                assert g["steps"] == w["steps"] == 3
                for key in ("loss", "loss_pc", "loss_po2pl", "loss_pl2pl", "num_po2pl_pairs",
                            "visible_pixels", "grad_norm"):
                    np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6,
                                               err_msg=f"{n} processes, epoch {epoch} {key}")
    logs = os.listdir(os.path.join(str(tmp_path / "runs"), config["experiment"]))
    assert sorted(logs) == ["mp2", "mp2-proc1", "mp2-resume", "mp2-resume-proc1"]
