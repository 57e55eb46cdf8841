"""The trainer: epochs over scan pairs from memory or from disk, the warmup
switch, checkpoints and resume, evaluation with best-state retention, and
metric logging.

The port of ``delora_tpu/training/trainer.py`` on one device:

- the feed is chosen as the reference's (trainer.py:67-90,
  ``config.py::training_feed``): "full" for the image matcher with the
  projection caches on, "raw" for brute correspondence or with the target
  cache off;
- scans come from memory (``Trainer(config, sequences)``: one dataset, the
  tables always on the device) or, with ``sequences`` None, from the
  preprocessed files of every dataset of ``config["datasets"]``
  (``data/dataset.py::ScanPairDataset``), one set of pairs a dataset;
- full feed with every scan within ``hbm_cache_scans``: every scan's
  projection artifacts (``ops/projection_host.py::scan_artifacts_np``, the
  scan truncated and padded to ``max_points``) are stacked once as tables on
  the device and batches are gathered there by index (reference
  trainer.py:133-191, :329-352); otherwise (and always for the raw feed
  from disk) batches stream from the host through ``BatchLoader`` with
  ``prefetch_depth`` batches made ahead (:541-548); in memory the raw feed's
  padded points, normals and masks are the tables;
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
  ``use_dropout`` the trainer owns the dropout masks' generator, on its
  device, seeded from its initialisation generator.

From disk the trainer also logs each epoch's metrics (``utils/metrics.py``),
saves a checkpoint when ``epoch % checkpoint_every_epochs == 0`` and after
the last epoch (``training/checkpoint.py``: ``latest``, and ``epoch_NNNNN``
every ``checkpoint_keep_every``), evaluates every ``eval_every_epochs``
unsupervised epochs with the ``Tester`` on the testing identifiers and keeps
the best state as ``best`` (trainer.py:249-295, :611-616), and resumes from
``checkpoint`` or, with ``auto_resume``, from ``latest`` (trainer.py:210-227):
model, optimizer, schedule, EMA and dropout generator come back, so a resumed
run takes the steps of an uninterrupted one; it starts after the saved epoch,
unsupervised.

A plain Python loop takes the steps: the reference's ``lax.scan`` over
``steps_per_dispatch`` steps only amortizes the TPU's dispatch round trip, so
the port does not read that key. Not ported: training images (the reference's
six-panel plots need matplotlib) and ``profile_epochs``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from delora_tpu_torch import resolve_device
from delora_tpu_torch.config import training_feed, validate
from delora_tpu_torch.data.dataset import (
    BatchLoader,
    ScanPairDataset,
    epoch_permutation,
    pad_scan,
)
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.ops.projection import ProjectionSpec
from delora_tpu_torch.ops.projection_host import ScanArtifacts, scan_artifacts_np
from delora_tpu_torch.training.checkpoint import CheckpointManager
from delora_tpu_torch.training.state import (
    deploy_model,
    ema_params,
    make_optimizer,
    make_param_ema,
)
from delora_tpu_torch.training.step import (
    FullyCachedBatch,
    ScanPairBatch,
    StepConfig,
    train_step,
)
from delora_tpu_torch.utils.metrics import MetricsLogger

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


def padded_artifacts(points: np.ndarray, normals: np.ndarray, max_points: int,
                     spec: ProjectionSpec) -> ScanArtifacts:
    """One scan's artifacts, the scan padded by :func:`padded_scan`, as the
    reference's dataset feeds ``scan_artifacts_np``."""
    return scan_artifacts_np(*padded_scan(points, normals, max_points), spec)


class PairFeed(NamedTuple):
    """One dataset's scan pairs on the trainer: device ``tables`` (full feed:
    ``ScanArtifacts`` of every scan; raw feed: (points, normals, valid)) with
    each pair's target and source rows, or a host ``loader``."""

    spec: ProjectionSpec
    tables: Optional[Union[ScanArtifacts, tuple]] = None
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
    (and the dropout generator's seed); by default it is seeded with the
    config's ``seed`` (0)."""

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
        self.dropout_generator = None
        if config["use_dropout"]:
            seed = int(torch.randint(0, 2**62, (), generator=generator))
            self.dropout_generator = torch.Generator(self.device).manual_seed(seed)

        if sequences is not None:
            self.feeds = {dataset: self._memory_feed(sequences, dataset)}
            self.ckpt = self.logger = None
        else:
            self.feeds = self._disk_feeds()
            self.ckpt = CheckpointManager(config.get("checkpoint_dir", "./checkpoints_tpu"),
                                          keep_every=int(config.get("checkpoint_keep_every", 5)))
            self.logger = MetricsLogger(config.get("log_dir", "./runs"),
                                        config.get("experiment", "default"), self.run_name,
                                        use_mlflow=bool(config.get("use_mlflow", False)))
            self.logger.log_params(self.config)
        self.start_epoch = 0
        self.best_eval: Optional[Tuple[float, int]] = None      # (score, epoch)
        self.last_steps: Dict[str, np.ndarray] = {}
        if self.ckpt is not None:
            self._resume()
        # Host seconds of the set-up: model, data, tables, resume.
        self.setup_seconds = time.perf_counter() - t0

    # ---- feeds ------------------------------------------------------------

    def _tables(self, rows: List[tuple]):
        """Stack each leaf of the per-scan ``rows`` over all scans, on the
        device (mean ranges, Python floats, as float32)."""
        leaves = []
        for leaf in zip(*rows):
            arr = np.stack([np.asarray(x) for x in leaf])
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)
            leaves.append(torch.from_numpy(arr).to(self.device))
        return ScanArtifacts(*leaves) if self.feed == "full" else tuple(leaves)

    def _memory_feed(self, sequences: Sequence[Sequence[Scan]], dataset: str) -> PairFeed:
        spec = ProjectionSpec.from_config(self.config, dataset)
        max_points = int(self.config[dataset]["max_points"])
        rows: List[tuple] = []
        tgt, src = [], []
        for scans in sequences:
            first = len(rows)
            if self.feed == "full":
                rows.extend(padded_artifacts(p, n, max_points, spec) for p, n in scans)
            else:
                rows.extend(padded_scan(p, n, max_points) for p, n in scans)
            tgt.extend(range(first, len(rows) - 1))
            src.extend(range(first + 1, len(rows)))
        if len(tgt) < self.batch_size:
            raise ValueError(f"{len(tgt)} scan pairs make no batch of {self.batch_size}")
        return PairFeed(spec, self._tables(rows), np.asarray(tgt, np.int64),
                        np.asarray(src, np.int64))

    def _disk_feeds(self) -> Dict[str, PairFeed]:
        config = self.config
        data = {name: ScanPairDataset(config, name) for name in self.datasets}
        for name, ds in data.items():
            if len(ds) < self.batch_size:
                raise ValueError(f"{name}: {len(ds)} scan pairs make no batch of "
                                 f"{self.batch_size}")
        if self.feed == "full" and bool(config.get("prewarm_cache", True)):
            threads = int(config.get("prewarm_threads", 8))
            t0 = time.time()
            n = sum(ds.prewarm_artifacts(threads) for ds in data.values())
            print(f"[trainer] prewarmed {n} scan projections in {time.time() - t0:.1f}s "
                  f"({threads} threads)", flush=True)
        total = sum(len(ds.scan_keys()) for ds in data.values())
        budget = int(config.get("hbm_cache_scans", 3072))
        resident = self.feed == "full" and 0 < budget and total <= budget
        if self.feed == "full" and not resident:
            print(f"[trainer] dataset ({total} scans) exceeds hbm_cache_scans={budget}; "
                  f"streaming from host", flush=True)
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
                    prefetch=max(1, int(config.get("prefetch_depth", 2))), feed=self.feed))
        if resident:
            print(f"[trainer] {total} scans resident in device memory "
                  f"({time.time() - t0:.1f}s one-time transfer)", flush=True)
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
              ) -> Union[FullyCachedBatch, ScanPairBatch]:
        """Gather the batch of pairs (tgt[i], src[i]) from the device tables."""
        t = self.feeds[dataset or self.dataset].tables
        if self.feed == "raw":
            return ScanPairBatch(*(x[tgt] for x in t), *(x[src] for x in t))
        return FullyCachedBatch(t.image[tgt], t.normal_image[tgt], t.mean_range[tgt],
                                t.image[src], t.src_points[src], t.src_normals[src],
                                t.src_valid[src], t.mean_range[src])

    def batches(self, epoch: int, dataset: str):
        """The epoch's batches of ``dataset``, on the device."""
        feed = self.feeds[dataset]
        if feed.loader is not None:
            yield from feed.loader.epoch(epoch)
            return
        order = self.epoch_indices(epoch, dataset).reshape(-1, self.batch_size)
        tgt = torch.from_numpy(feed.pair_target[order]).to(self.device)
        src = torch.from_numpy(feed.pair_source[order]).to(self.device)
        for ti, si in zip(tgt, src):
            yield self.batch(ti, si, dataset)

    # ---- steps and epochs -------------------------------------------------

    def step(self, batch: Union[FullyCachedBatch, ScanPairBatch], cfg: StepConfig
             ) -> Dict[str, torch.Tensor]:
        """One train step of the trainer's model, optimizer, schedule, EMA and
        dropout generator."""
        return train_step(self.model, self.optimizer, batch, cfg, self.schedule, self.ema,
                          self.dropout_generator)

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
            per_step.extend(self.step(batch, cfg) for batch in self.batches(epoch, dataset))
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
        if self.logger is not None and self.config.get("visualize_images", True):
            print("[trainer] training images are not ported yet; visualize_images is ignored",
                  flush=True)
        history = []
        for epoch in range(self.start_epoch, epochs):
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
                eval_every = int(self.config.get("eval_every_epochs", 0))
                if eval_every and not self.supervised and (
                        (epoch + 1) % eval_every == 0 or epoch == epochs - 1):
                    self.evaluate(epoch)
            if self.supervised and metrics["loss"] < WARMUP_LOSS:
                self.supervised = False
                print("[trainer] warmup converged: switching to unsupervised", flush=True)
        return history

    # ---- checkpoints and evaluation ---------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """What a checkpoint holds: the model, the optimizer, the schedule,
        and the EMA and the dropout generator's state where the run has
        them."""
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "schedule": self.schedule.state_dict()}
        if self.ema is not None:
            state["ema"] = ema_params(self.ema)
        if self.dropout_generator is not None:
            state["dropout_generator"] = self.dropout_generator.get_state()
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
        without ground truth. The best state so far is saved as ``best``."""
        from delora_tpu_torch.training.tester import Tester

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
