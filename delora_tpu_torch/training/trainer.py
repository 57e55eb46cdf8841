"""The trainer: epochs over scan pairs from memory or from disk, the warmup
switch, checkpoints and resume, evaluation with best-state retention, and
metric logging.

The port of ``delora_tpu/training/trainer.py`` on one device:

- the feed is chosen as the reference's (trainer.py:67-90,
  ``config.py::training_feed``): "full" for the image or projective matcher
  with both projection caches on, "cached" (target artifacts, raw source)
  with ``cache_source_projections: false``, "raw" for brute correspondence
  or with the target cache off;
- scans come from memory (``Trainer(config, sequences)``: one dataset, the
  tables always on the device) or, with ``sequences`` None, from the
  preprocessed files of every dataset of ``config["datasets"]``
  (``data/dataset.py::ScanPairDataset``), one set of pairs a dataset;
- full feed with every scan within ``hbm_cache_scans``: every scan's
  projection artifacts (``ops/projection_host.py::scan_artifacts_np``, the
  scan truncated and padded to ``max_points``) are stacked once as tables on
  the device and batches are gathered there by index (reference
  trainer.py:133-191, :329-352); otherwise (and always for the cached and
  raw feeds from disk) batches stream from the host through ``BatchLoader``
  with ``prefetch_depth`` batches made ahead (:541-548); in memory the raw
  feed's padded points, normals and masks are the tables, and the cached
  feed's are every scan's target artifacts beside them;
- pairs are consecutive scans and never cross sequences; each dataset's
  epoch runs in turn, in the order ``np.random.default_rng(seed +
  epoch).permutation`` truncated to whole batches (data/dataset.py:281-296);
- metrics stay on the device until the epoch ends and are read back once
  (trainer.py:552-568);
- the supervised identity warmup switches to unsupervised when an epoch's
  mean loss falls below 1e-2 (trainer.py:617-620); ``unsupervised_at_start``
  skips it;
- with ``ema_decay`` > 0 the parameter EMA follows every step, and
  :meth:`Trainer.deploy_model` is the model to evaluate or serve; with
  ``use_dropout`` the trainer owns the dropout masks' generator, and with
  ``random_point_cloud_rotations`` the augmentation's, each on its device and
  seeded from its initialisation generator (dropout's first), so runs
  without them draw what they drew before.

From disk the trainer also logs each epoch's metrics (``utils/metrics.py``),
saves a checkpoint when ``epoch % checkpoint_every_epochs == 0`` and after
the last epoch (``training/checkpoint.py``: ``latest``, and ``epoch_NNNNN``
every ``checkpoint_keep_every``), evaluates every ``eval_every_epochs``
unsupervised epochs with the ``Tester`` on the testing identifiers and keeps
the best state as ``best`` (trainer.py:249-295, :611-616), and resumes from
``checkpoint`` or, with ``auto_resume``, from ``latest`` (trainer.py:210-227):
model, optimizer, schedule, EMA and the dropout and augmentation generators
come back, so a resumed run takes the steps of an uninterrupted one; it
starts after the saved epoch, unsupervised.

The trainer traces the epochs of ``profile_epochs`` (``utils/profiling.py``:
each step's ``batch`` and ``train_step`` regions, with the device's kernels
on the card) into the run's ``profile`` artifact directory
(trainer.py:572-579). From disk, with ``visualize_images``, it renders the
six-panel diagnostic of :func:`training_panels` every
``visualize_every_epochs`` epochs (5 by default) into
``images_<dataset>_<epoch>.png`` (trainer.py:359-459, :597-609). The
plotting module is imported first: without matplotlib one line says the
images are skipped and nothing is computed.

A plain Python loop takes the steps: the reference's ``lax.scan`` over
``steps_per_dispatch`` steps only amortizes the TPU's dispatch round trip, so
the port does not read that key.

Under data parallelism (a ``torch.distributed`` group joined before the
trainer is made, ``parallel/dist.py``; one process a device) the same trainer
runs on every process, as the reference's runs on every host
(trainer.py:95-100, :137-233, :264-266, :593-605):

- ``batch_size`` stays the global batch (the learning-rate scaling and the
  reported pairs/s read it); each process steps on its share, rows ``rank``,
  ``rank + world``, ... of every global batch, through
  ``training/step.py::train_step`` with ``StepConfig.shard`` set, so every
  metric, the warmup switch included, is the global step's on every process;
- streamed batches come from a ``BatchLoader`` shard a process; device
  tables are resident when every scan fits ``hbm_cache_scans`` times the
  world size (the budget is a process's), and are then split over the
  processes (``parallel/step.py::ShardedTables``), each step's rows sent by
  their owners;
- every process saves (process 0 writes, ``training/checkpoint.py``) and
  restores the same checkpoint, and rank 0's state is broadcast after the
  set-up; processes other than 0 log their metrics to the run
  ``<run>-proc<rank>``;
- evaluation and image logging run with a single process only.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from delora_tpu_torch import resolve_device, se3
from delora_tpu_torch.config import training_feed, validate
from delora_tpu_torch.data.dataset import (
    BatchLoader,
    ScanPairDataset,
    epoch_permutation,
    pad_scan,
)
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.ops.correspondence import image_space_correspondence_batch
from delora_tpu_torch.ops.projection import (
    ProjectionSpec,
    project_compact_exact_batch,
    project_image_packed_batch,
)
from delora_tpu_torch.ops.projection_host import ScanArtifacts, scan_artifacts_np
from delora_tpu_torch.parallel import dist as pdist
from delora_tpu_torch.parallel.step import ShardedTables, broadcast_state
from delora_tpu_torch.training.checkpoint import CheckpointManager
from delora_tpu_torch.training.state import (
    deploy_model,
    ema_params,
    make_optimizer,
    make_param_ema,
)
from delora_tpu_torch.training.step import (
    CachedTargetBatch,
    FullyCachedBatch,
    ScanPairBatch,
    StepConfig,
    forward_pose,
    train_step,
)
from delora_tpu_torch.utils.metrics import MetricsLogger
from delora_tpu_torch.utils.profiling import annotate, trace

WARMUP_LOSS = 1e-2

Scan = Tuple[np.ndarray, np.ndarray]       # (points [N, >=3], normals [N, 3])


def padded_scan(points: np.ndarray, normals: np.ndarray, max_points: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One scan truncated and zero-padded to ``max_points`` -> (points
    [max_points, 3], normals [max_points, 3], validity mask), as the
    reference's dataset pads it."""
    n = min(len(points), max_points)
    return pad_scan(np.asarray(points, np.float32)[:n], np.asarray(normals, np.float32)[:n],
                    max_points)


PANEL_FIELDS = ("points_1", "valid_1", "normals_1", "points_2", "valid_2", "normals_2")


@torch.no_grad()
def training_panels(model: torch.nn.Module, pair, spec: ProjectionSpec,
                    window: Tuple[int, int], device: torch.device
                    ) -> Tuple[torch.Tensor, ...]:
    """The six panels of the training diagnostic at one probe pair, from the
    model's current weights (dropout off), on ``device``, as the reference's
    ``Trainer.log_images`` computes them (trainer.py:359-459):

    - the target's and the source's range images ([H, W]): both scans
      projected under the exact rule, their normals riding along;
    - the range of the network-transformed source ([H, W]): the source's
      winners warped by the predicted pose and projected again (packed rule);
    - the per-pixel po2pl loss on the transformed source ([H, W]): the
      squared point-to-plane residual of each hard window match whose target
      has a normal, else 0;
    - the target's and the transformed source's normal maps ([H, W, 3]).

    ``pair`` holds a padded pair's ``points_1``, ``valid_1``, ``normals_1``,
    ``points_2``, ``valid_2``, ``normals_2`` (``ScanPairDataset.get_pair``).
    On the card: two exact placements, one packed and one matcher launch."""
    p1, v1, n1, p2, v2, n2 = (torch.as_tensor(np.asarray(pair[k])).to(device)
                              for k in PANEL_FIELDS)
    tproj = project_compact_exact_batch(p1[None], v1[None], spec,
                                        values=torch.cat([p1, n1], -1)[None])
    sproj = project_compact_exact_batch(p2[None], v2[None], spec,
                                        values=torch.cat([p2, n2], -1)[None])
    timg, simg = tproj.image[0], sproj.image[0]
    image_1 = torch.cat([timg[..., 0:3], timg[..., 6:7]], -1)
    image_2 = torch.cat([simg[..., 0:3], simg[..., 6:7]], -1)
    nimg_t = timg[..., 3:6]
    T = forward_pose(model, image_1[None], image_2[None], deterministic=True)[0]
    m = sproj.comp_mask[0, :, None]
    w_pts = se3.transform_points(T, sproj.comp_vals[0, :, 0:3] * m)
    w_nrm = se3.rotate_points(T, sproj.comp_vals[0, :, 3:6] * m)
    wimg = project_image_packed_batch(w_pts[None], sproj.comp_mask, spec,
                                      values=torch.cat([w_pts, w_nrm], -1)[None])[0]
    H, W = spec.height, spec.width
    w_xyz = wimg[..., 0:3].reshape(H * W, 3)
    occ = wimg[..., 6].reshape(H * W) > 0.0
    corr = image_space_correspondence_batch(w_xyz[None], occ[None], image_1[None],
                                            nimg_t[None], spec, window)
    nt = corr.target_normals[0]
    resid = ((w_xyz - corr.target_points[0]) * nt).sum(-1)
    po2pl = torch.where(corr.valid[0] & (nt != 0.0).any(-1), resid * resid, 0.0)
    return (image_1[..., 3], image_2[..., 3], wimg[..., 6], po2pl.reshape(H, W), nimg_t,
            wimg[..., 3:6])


# Per feed: the table leaves of a pair's target row and of its source row, in
# the order of the batch's fields, and the batch type.
BATCH_LEAVES = {
    "full": ((0, 1, 2), (0, 3, 4, 5, 2), FullyCachedBatch),
    "cached": ((0, 1, 2), (3, 4, 5), CachedTargetBatch),
    "raw": ((0, 1, 2), (0, 1, 2), ScanPairBatch),
}


class PairFeed(NamedTuple):
    """One dataset's scan pairs on the trainer: device ``tables`` (full feed:
    ``ScanArtifacts`` of every scan; raw feed: (points, normals, valid);
    cached feed: (image, normal_image, mean_range, points, normals, valid);
    split over the processes under data parallelism) with each pair's target
    and source rows, or a host ``loader``."""

    spec: ProjectionSpec
    tables: Optional[Union[ScanArtifacts, tuple, ShardedTables]] = None
    pair_target: Optional[np.ndarray] = None
    pair_source: Optional[np.ndarray] = None
    loader: Optional[BatchLoader] = None

    @property
    def num_pairs(self) -> int:
        return len(self.loader.dataset) if self.loader is not None else len(self.pair_target)


class Trainer:
    """Trains the odometry model (see the module docstring). ``sequences``
    holds, per sequence, a list of (points, normals) arrays of ``dataset``; a
    zero normal means "no normal"; None reads every dataset of
    ``config["datasets"]`` from disk. ``generator`` seeds the initialisation
    (and the dropout and augmentation generators' seeds); by default it is
    seeded with the config's ``seed`` (0)."""

    def __init__(self, config, sequences: Optional[Sequence[Sequence[Scan]]] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 dataset: str = "kitti", generator: Optional[torch.Generator] = None,
                 run_name: Optional[str] = None):
        t0 = time.perf_counter()
        validate(config)
        self.config = dict(config)
        self.device = resolve_device(device)
        self.datasets = [dataset] if sequences is not None else list(config["datasets"])
        self.dataset = self.datasets[0]
        self.batch_size = int(config["batch_size"])
        self.world, self.rank = pdist.world_size(), pdist.rank()
        if self.batch_size % self.world:
            raise ValueError(f"batch_size {self.batch_size} must divide evenly across "
                             f"{self.world} processes")
        self.seed = int(config.get("seed", 0))
        self.supervised = not bool(config["unsupervised_at_start"])
        self.feed = training_feed(config)
        self.run_name = run_name or config.get("training_run_name", "run")

        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        self.model = OdometryModel(ModelConfig.from_config(config), generator).to(self.device)
        self.model.train()
        self.optimizer, self.schedule = make_optimizer(
            config, self.model.parameters(), self.batch_size)
        self.ema = make_param_ema(config, self.model)
        self.dropout_generator = self.augment_generator = None
        if config["use_dropout"]:
            seed = int(torch.randint(0, 2**62, (), generator=generator))
            self.dropout_generator = torch.Generator(self.device).manual_seed(seed)
        if config["random_point_cloud_rotations"]:
            seed = int(torch.randint(0, 2**62, (), generator=generator))
            self.augment_generator = torch.Generator(self.device).manual_seed(seed)

        self.pair_datasets: Dict[str, ScanPairDataset] = {}
        if sequences is not None:
            self.feeds = {dataset: self._memory_feed(sequences, dataset)}
            self.ckpt = self.logger = None
        else:
            self.feeds = self._disk_feeds()
            self.ckpt = CheckpointManager(config.get("checkpoint_dir", "./checkpoints_tpu"),
                                          keep_every=int(config.get("checkpoint_keep_every", 5)))
            # One metrics stream a process; process 0 holds the run's own.
            log_run = self.run_name if self.rank == 0 else f"{self.run_name}-proc{self.rank}"
            self.logger = MetricsLogger(config.get("log_dir", "./runs"),
                                        config.get("experiment", "default"), log_run,
                                        use_mlflow=bool(config.get("use_mlflow", False)))
            self.logger.log_params(self.config)
        self.start_epoch = 0
        self.best_eval: Optional[Tuple[float, int]] = None      # (score, epoch)
        self.last_steps: Dict[str, np.ndarray] = {}
        if self.ckpt is not None:
            self._resume()
        broadcast_state(self.model, self.optimizer, self.schedule, self.ema,
                        (self.dropout_generator, self.augment_generator))
        # Host seconds of the set-up: model, data, tables, resume.
        self.setup_seconds = time.perf_counter() - t0

    # ---- feeds ------------------------------------------------------------

    def _tables(self, rows: List[tuple]):
        """Stack each leaf of the per-scan ``rows`` over all scans, on the
        device (mean ranges, Python floats, as float32); split over the
        processes under data parallelism."""
        leaves = []
        for leaf in zip(*rows):
            arr = np.stack([np.asarray(x) for x in leaf])
            leaves.append(arr.astype(np.float32) if arr.dtype == np.float64 else arr)
        if pdist.active():
            return ShardedTables(leaves, self.device)
        leaves = [torch.from_numpy(arr).to(self.device) for arr in leaves]
        return ScanArtifacts(*leaves) if self.feed == "full" else tuple(leaves)

    def _memory_feed(self, sequences: Sequence[Sequence[Scan]], dataset: str) -> PairFeed:
        spec = ProjectionSpec.from_config(self.config, dataset)
        max_points = int(self.config[dataset]["max_points"])
        rows: List[tuple] = []
        tgt, src = [], []
        for scans in sequences:
            first = len(rows)
            for p, n in scans:
                padded = padded_scan(p, n, max_points)
                if self.feed == "raw":
                    rows.append(padded)
                elif self.feed == "full":
                    rows.append(scan_artifacts_np(*padded, spec))
                else:
                    a = scan_artifacts_np(*padded, spec)
                    rows.append((a.image, a.normal_image, a.mean_range, *padded))
            tgt.extend(range(first, len(rows) - 1))
            src.extend(range(first + 1, len(rows)))
        if len(tgt) < self.batch_size:
            raise ValueError(f"{len(tgt)} scan pairs make no batch of {self.batch_size}")
        return PairFeed(spec, self._tables(rows), np.asarray(tgt, np.int64),
                        np.asarray(src, np.int64))

    def _disk_feeds(self) -> Dict[str, PairFeed]:
        config = self.config
        data = self.pair_datasets = {name: ScanPairDataset(config, name)
                                     for name in self.datasets}
        for name, ds in data.items():
            if len(ds) < self.batch_size:
                raise ValueError(f"{name}: {len(ds)} scan pairs make no batch of "
                                 f"{self.batch_size}")
        if self.feed != "raw" and bool(config.get("prewarm_cache", True)):
            threads = int(config.get("prewarm_threads", 8))
            t0 = time.time()
            n = sum(ds.prewarm_artifacts(threads) for ds in data.values())
            print(f"[trainer] prewarmed {n} scan projections in {time.time() - t0:.1f}s "
                  f"({threads} threads)", flush=True)
        total = sum(len(ds.scan_keys()) for ds in data.values())
        # A process's budget: the tables split over the processes.
        budget = int(config.get("hbm_cache_scans", 3072))
        resident = self.feed == "full" and 0 < budget and total <= budget * self.world
        if self.feed == "full" and not resident:
            print(f"[trainer] dataset ({total} scans) exceeds hbm_cache_scans={budget} x "
                  f"{self.world} processes; streaming from host", flush=True)
        feeds = {}
        t0 = time.time()
        for name, ds in data.items():
            spec = ProjectionSpec.from_config(config, name)
            if resident:
                keys = ds.scan_keys()
                row = {key: i for i, key in enumerate(keys)}
                feeds[name] = PairFeed(
                    spec, self._tables([ds.scan_artifacts(*key) for key in keys]),
                    np.asarray([row[(si, k)] for si, k in ds.pairs], np.int64),
                    np.asarray([row[(si, k + 1)] for si, k in ds.pairs], np.int64))
            else:
                feeds[name] = PairFeed(spec, loader=BatchLoader(
                    ds, self.batch_size, device=self.device, seed=self.seed,
                    prefetch=max(1, int(config.get("prefetch_depth", 2))), feed=self.feed,
                    native=config.get("native_io", "auto"), num_shards=self.world,
                    shard_index=self.rank))
        if resident:
            print(f"[trainer] {total} scans resident in device memory "
                  f"({time.time() - t0:.1f}s one-time transfer; {self.world} process "
                  f"shard(s))", flush=True)
        return feeds

    @property
    def num_pairs(self) -> int:
        return sum(feed.num_pairs for feed in self.feeds.values())

    def epoch_indices(self, epoch: int, dataset: Optional[str] = None) -> np.ndarray:
        """The epoch's pair order of ``dataset`` (the first by default),
        truncated to whole batches."""
        feed = self.feeds[dataset or self.dataset]
        return epoch_permutation(feed.num_pairs, self.batch_size, self.seed, epoch)

    def batch(self, tgt: torch.Tensor, src: torch.Tensor, dataset: Optional[str] = None
              ) -> Union[FullyCachedBatch, CachedTargetBatch, ScanPairBatch]:
        """Gather the batch of pairs (tgt[i], src[i]) from the device tables
        of a single process."""
        t = self.feeds[dataset or self.dataset].tables
        tgt_leaves, src_leaves, kind = BATCH_LEAVES[self.feed]
        return kind(*(t[i][tgt] for i in tgt_leaves), *(t[i][src] for i in src_leaves))

    def sharded_batch(self, tgt: np.ndarray, src: np.ndarray, dataset: Optional[str] = None
                      ) -> Union[FullyCachedBatch, CachedTargetBatch, ScanPairBatch]:
        """Collective: this process's share of the global batch of pairs
        (tgt[i], src[i]) from the tables split over the processes."""
        tables = self.feeds[dataset or self.dataset].tables
        tgt_leaves, src_leaves, kind = BATCH_LEAVES[self.feed]
        n = self.world
        return kind(*tables.gather([tgt[r::n] for r in range(n)], tgt_leaves),
                    *tables.gather([src[r::n] for r in range(n)], src_leaves))

    def batches(self, epoch: int, dataset: str):
        """The epoch's batches of ``dataset`` (this process's shares), on the
        device."""
        feed = self.feeds[dataset]
        if feed.loader is not None:
            yield from feed.loader.epoch(epoch)
            return
        order = self.epoch_indices(epoch, dataset).reshape(-1, self.batch_size)
        if pdist.active():
            for chunk in order:
                yield self.sharded_batch(feed.pair_target[chunk], feed.pair_source[chunk],
                                         dataset)
            return
        tgt = torch.from_numpy(feed.pair_target[order]).to(self.device)
        src = torch.from_numpy(feed.pair_source[order]).to(self.device)
        for ti, si in zip(tgt, src):
            yield self.batch(ti, si, dataset)

    # ---- steps and epochs -------------------------------------------------

    def step(self, batch: Union[FullyCachedBatch, CachedTargetBatch, ScanPairBatch],
             cfg: StepConfig) -> Dict[str, torch.Tensor]:
        """One train step of the trainer's model, optimizer, schedule, EMA,
        dropout and augmentation generators (data-parallel over the
        processes in a process group: ``cfg.shard`` set)."""
        if pdist.active():
            cfg = cfg._replace(shard=pdist.batch_shard())
        return train_step(self.model, self.optimizer, batch, cfg, self.schedule, self.ema,
                          self.dropout_generator, self.augment_generator)

    def deploy_model(self) -> torch.nn.Module:
        """The model to evaluate or serve: the EMA weights when tracked."""
        return deploy_model(self.model, self.ema)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch -> the mean of each step metric, with ``steps``,
        ``epoch_seconds`` and ``scan_pairs_per_sec``. Each step's values stay
        in ``last_steps`` (metric -> numpy array over the epoch's steps)."""
        t0 = time.perf_counter()
        per_step = []
        for dataset in self.datasets:
            cfg = StepConfig.from_config(self.config, dataset, supervised=self.supervised)
            batches = self.batches(epoch, dataset)
            while True:
                with annotate("batch"):
                    batch = next(batches, None)
                if batch is None:
                    break
                with annotate("train_step"):
                    per_step.append(self.step(batch, cfg))
        if not per_step:
            raise RuntimeError("No batches produced: dataset smaller than a batch?")
        keys = list(per_step[0])
        # One readback for the whole epoch.
        mat = torch.stack([torch.stack([m[k] for k in keys]) for m in per_step]).cpu().numpy()
        self.last_steps = {k: mat[:, i] for i, k in enumerate(keys)}
        out = {k: float(mat[:, i].mean()) for i, k in enumerate(keys)}
        out["steps"] = len(per_step)
        out["epoch_seconds"] = time.perf_counter() - t0
        out["scan_pairs_per_sec"] = len(per_step) * self.batch_size / out["epoch_seconds"]
        return out

    def train(self, epochs: Optional[int] = None) -> List[Dict[str, float]]:
        """Epochs ``start_epoch`` .. ``epochs`` - 1 (the config's ``epochs``
        if None) -> each epoch's metrics, with ``supervised`` as 1.0 or 0.0.
        From disk, each epoch is logged, checkpointed and evaluated on the
        config's cadence."""
        epochs = int(epochs if epochs is not None else self.config["epochs"])
        profile_epochs = set(self.config.get("profile_epochs") or [])
        history = []
        for epoch in range(self.start_epoch, epochs):
            if epoch in profile_epochs:
                with trace(self.artifact_path("profile"), f"epoch_{epoch:05d}"):
                    metrics = self.train_epoch(epoch)
            else:
                metrics = self.train_epoch(epoch)
            metrics["supervised"] = float(self.supervised)
            history.append(metrics)
            print(f"[epoch {epoch:05d}] loss={metrics['loss']:.6f} "
                  f"pc={metrics['loss_pc']:.6f} po2pl={metrics['loss_po2pl']:.6f} "
                  f"pl2pl={metrics['loss_pl2pl']:.6f} "
                  f"pairs/s={metrics['scan_pairs_per_sec']:.1f} "
                  f"supervised={self.supervised}", flush=True)
            if self.logger is not None:
                self.logger.log_metrics(metrics, step=epoch)
                every = max(int(self.config.get("checkpoint_every_epochs", 1)), 1)
                if epoch % every == 0 or epoch == epochs - 1:
                    self.ckpt.save(self.state_dict(), epoch, metrics["loss"], self.config)
                viz_every = max(int(self.config.get("visualize_every_epochs", 5)), 1)
                if self.world == 1 and self.config.get("visualize_images", True) \
                        and epoch % viz_every == 0:
                    for name in self.datasets:
                        self.log_images(epoch, name)
                eval_every = int(self.config.get("eval_every_epochs", 0))
                if eval_every and not self.supervised and (
                        (epoch + 1) % eval_every == 0 or epoch == epochs - 1):
                    self.evaluate(epoch)
            if self.supervised and metrics["loss"] < WARMUP_LOSS:
                self.supervised = False
                print("[trainer] warmup converged: switching to unsupervised", flush=True)
        return history

    # ---- artifacts --------------------------------------------------------

    def artifact_path(self, name: str) -> str:
        """``name`` in the run's artifact directory,
        ``<log_dir>/<experiment>/<run>/artifacts`` (also for a trainer over
        in-memory scans, which keeps no log)."""
        if self.logger is not None:
            return self.logger.artifact_path(name)
        return os.path.join(self.config.get("log_dir", "./runs"),
                            self.config.get("experiment", "default"), self.run_name,
                            "artifacts", name)

    def log_images(self, epoch: int, dataset: str) -> Optional[str]:
        """Render :func:`training_panels` of the dataset's first pair into
        ``images_<dataset>_<epoch>.png`` -> its path; without matplotlib,
        one line and None (nothing is computed)."""
        try:
            from delora_tpu_torch.utils.plotting import plot_training_panels
        except ImportError as e:
            print(f"[trainer] image logging skipped: {e}", flush=True)
            return None
        spec = ProjectionSpec.from_config(self.config, dataset)
        panels = training_panels(self.model, self.pair_datasets[dataset].get_pair(0), spec,
                                 tuple(self.config["projective_window"]), self.device)
        r1, r2, rw, po2pl, nimg_t, nimg_w = (x.float().cpu().numpy() for x in panels)
        path = self.artifact_path(f"images_{dataset}_{epoch:05d}.png")
        plot_training_panels([
            ("Target image at time t", "range", r1),
            ("Source at time t+1", "range", r2),
            ("Network transformed source at time t+1", "range", rw),
            ("Po2Pl loss (on transformed source points)", "loss", po2pl),
            ("Normal map of target", "normals", nimg_t),
            ("Normal map of transformed source", "normals", nimg_w),
        ], path, iteration=epoch)
        return path

    # ---- checkpoints and evaluation ---------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """What a checkpoint holds: the model, the optimizer, the schedule,
        and the EMA and the dropout and augmentation generators' states where
        the run has them."""
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "schedule": self.schedule.state_dict()}
        if self.ema is not None:
            state["ema"] = ema_params(self.ema)
        if self.dropout_generator is not None:
            state["dropout_generator"] = self.dropout_generator.get_state()
        if self.augment_generator is not None:
            state["augment_generator"] = self.augment_generator.get_state()
        return state

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.schedule.load_state_dict(state["schedule"])
        if self.ema is not None:
            with torch.no_grad():
                ema = state["ema"]
                for name, value in zip(self.ema.names, self.ema.params):
                    value.copy_(ema[name])
        if self.dropout_generator is not None:
            self.dropout_generator.set_state(state["dropout_generator"])
        if self.augment_generator is not None:
            self.augment_generator.set_state(state["augment_generator"])

    def _resume(self) -> None:
        checkpoint = self.config.get("checkpoint")
        if not checkpoint and self.config.get("auto_resume", False):
            if os.path.exists(self.ckpt.path("latest")):
                checkpoint = "latest"
                print("[trainer] auto_resume: found existing 'latest' checkpoint", flush=True)
        if checkpoint:
            state, meta = self.ckpt.restore(checkpoint)
            self.load_state_dict(state)
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.supervised = False        # pretrained: straight to unsupervised
            print(f"[trainer] resumed from {checkpoint} (epoch {self.start_epoch})", flush=True)

    def evaluate(self, epoch: int) -> Optional[float]:
        """The Tester's trajectory metric on the testing identifiers with the
        deploy model -> the score (the mean first metric over the sequences
        with ground truth: t_rel % for >= 100 m, else RPE m/step), or None
        without ground truth or with more than one process (the reference
        evaluates multi-process runs offline). The best state so far is saved
        as ``best``."""
        from delora_tpu_torch.training.tester import Tester

        if self.world > 1:
            return None

        cfg = dict(self.config)
        for name in self.datasets:
            spec = dict(cfg[name])
            spec["data_identifiers"] = list(spec["testing_identifiers"])
            cfg[name] = spec
        results = Tester(cfg, model=self.deploy_model(), device=self.device,
                         run_name=f"{self.run_name}_eval_ep{epoch:04d}").test()
        vals = [m[0] for seqs in results.values() for m in seqs.values() if m]
        if not vals:
            return None
        score = float(np.mean(vals))
        self.logger.log_metrics({"eval_score": score}, step=epoch)
        sofar = (f"best so far {self.best_eval[0]:.3f} @ {self.best_eval[1]}"
                 if self.best_eval else "first eval")
        print(f"[trainer] eval @ epoch {epoch}: score={score:.3f} ({sofar})", flush=True)
        if self.best_eval is None or score < self.best_eval[0]:
            self.best_eval = (score, epoch)
            self.ckpt.save_named(self.state_dict(), "best", epoch, score, self.config,
                                 extra_meta={"eval_score": score})
            print(f"[trainer] new best eval score {score:.3f} -> checkpoint 'best'",
                  flush=True)
        return score
