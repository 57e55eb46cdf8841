"""One program in several processes on one machine: the data-parallel trainer
run in 1 and in N processes and compared.

The port of ``scripts/multiprocess_smoke.py``. One module, three roles:

- **parent** (:func:`compare`, or ``python -m
  delora_tpu_torch.parallel.multiprocess``): writes a synthetic drive and
  preprocesses it in a child process when asked (:func:`prepare_drive`), then
  runs :func:`train_run` in one process and in N, and compares them: every
  process of a run reports the same losses, the N-process run's per-epoch
  losses lie within ``rtol`` of the one-process run's, process 0 alone wrote
  the checkpoints, and every process resumed from them;
- **worker** (``python -m delora_tpu_torch.parallel.multiprocess call``,
  started by :func:`run_group`): joins the group over
  ``tcp://127.0.0.1:<port>`` with the backend and device it is given (no
  group for a single process, unless asked for a group of one), calls a
  function named ``module:function`` with pickled keyword arguments and the
  device, pickles what it returns, and leaves the group;
- **trainer** (:func:`train_run`, in each worker): the disk ``Trainer`` for
  some epochs (device tables where they fit), then a fresh ``Trainer``
  resumed from ``latest`` for one more, streamed from the host.

Every group gets a free port (the system's choice for port 0). Every wait is
bounded: when a process fails the others are killed at once, and when a group
outlives its ``timeout`` every process is killed and :func:`run_group`
raises, with the end of each process's log.

    python -m delora_tpu_torch.parallel.multiprocess [--nproc 2] [--device cpu]
        [--backend gloo] [--dir DIR]

runs process r on ``cuda:r`` (NCCL) unless ``--device`` names another device
for every process, and prints one JSON line with the verdict and exits 0 only if every check holds.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

from delora_tpu_torch.ops.cuda.launches import launch_counters, launch_counts

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODULE = "delora_tpu_torch.parallel.multiprocess"


def free_port() -> int:
    """A TCP port that is free now on 127.0.0.1 (bound as port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, lines: int = 30) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-lines:])
    except OSError:
        return "(no log)"


def run_processes(commands: Sequence[Sequence[str]], logs: Sequence[str],
                  timeout: float) -> None:
    """Start every command at once in the repository's root (its output to
    its log) and wait for all, at most ``timeout`` seconds in all. When one
    fails, or the time is up, every process still running is killed and
    RuntimeError (TimeoutError) raised with the end of each log."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    try:
        for cmd, log in zip(commands, logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(list(cmd), cwd=REPO, env=env, stdout=out,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"processes still running after {timeout:.0f} s:\n" +
                                   "\n".join(f"--- {log}\n{_tail(log)}" for log in logs))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f"processes exited {rcs}:\n" +
                           "\n".join(f"--- {log}\n{_tail(log)}" for log in logs))


def run_group(target: str, nproc: int, kwargs: Dict[str, Any], *, workdir: str,
              device: Optional[str] = None, backend: Optional[str] = None,
              timeout: float = 600.0,
              single_process_group: bool = False, threads: Optional[int] = None
              ) -> List[Any]:
    """Run ``target`` (``module:function``) in ``nproc`` worker processes of
    one group on ``device`` (by default rank r on ``cuda:r``, one process a
    card) -> what each rank's call returned, by rank. The function gets its
    device (a ``torch.device``) and ``kwargs``.
    ``backend`` defaults to NCCL on CUDA and gloo on the CPU; ``threads``
    sets each worker's intra-op threads."""
    os.makedirs(workdir, exist_ok=True)
    args_path = os.path.join(workdir, "kwargs.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(kwargs, f)
    port = free_port()
    outs = [os.path.join(workdir, f"out_{r}.pkl") for r in range(nproc)]
    logs = [os.path.join(workdir, f"log_{r}.txt") for r in range(nproc)]
    commands = []
    for r in range(nproc):
        cmd = [sys.executable, "-m", MODULE, "call", target, "--rank", str(r), "--world",
               str(nproc), "--port", str(port), "--device", device or f"cuda:{r}",
               "--args", args_path, "--out", outs[r]]
        cmd += ["--backend", backend] if backend else []
        cmd += ["--group"] if single_process_group else []
        cmd += ["--threads", str(threads)] if threads else []
        commands.append(cmd)
    run_processes(commands, logs, timeout)
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def _worker(args) -> None:
    import torch

    from delora_tpu_torch.parallel import dist as pdist

    if args.threads:
        torch.set_num_threads(args.threads)
    device = pdist.process_device(args.device)
    pdist.initialize_distributed(args.backend, device=device, rank=args.rank,
                                 world_size=args.world,
                                 init_method=f"tcp://127.0.0.1:{args.port}",
                                 single_process_group=args.group)
    try:
        module, _, name = args.target.partition(":")
        with open(args.args, "rb") as f:
            kwargs = pickle.load(f)
        result = getattr(importlib.import_module(module), name)(device=device, **kwargs)
        with open(args.out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(args.out + ".tmp", args.out)
    finally:
        pdist.shutdown()


def kernel_launches() -> Dict[str, int]:
    """Each kernel's launch count in this process."""
    return launch_counts()


def reset_kernel_launches() -> None:
    """Every kernel's launch count in this process to 0."""
    for wrapper, attr in launch_counters().values():
        setattr(wrapper, attr, 0)


def _recording_steps(trainer, step_losses: List[List[float]]):
    """``trainer``, its every epoch's per-step losses appended to
    ``step_losses``."""
    run_epoch = trainer.train_epoch

    def recorded(epoch):
        out = run_epoch(epoch)
        step_losses.append(trainer.last_steps["loss"].tolist())
        return out

    trainer.train_epoch = recorded
    return trainer


def deterministic_kernels() -> None:
    """TF32 off and deterministic kernels in this process, for runs on the
    card that are compared: two runs of the same work then agree bit for bit
    and a difference is the code's (cuDNN's default kernels make the plain
    trainer differ from itself). cuBLAS reads the workspace setting at its
    first use, so call this before any work on the card."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)


def train_run(device, config: Dict[str, Any], epochs: int, run_name: str = "mp",
              init_weights: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The trainer role: ``epochs`` epochs of the disk ``Trainer`` (its
    checkpoints on the config's cadence), then a fresh ``Trainer`` resumed
    from ``latest`` for one more, streamed from the host (``hbm_cache_scans``
    0). ``init_weights`` (a state_dict of numpy arrays)
    replaces the seeded initial weights before the first step. On the card
    TF32 is off and the kernels deterministic. -> this process's rank, world
    size, per-epoch losses and metrics, each epoch's per-step losses,
    checkpoint files written, whether the resumed weights equal the saved
    ones, its start epoch, the feeds taken and the kernel launches of each
    leg."""
    import numpy as np
    import torch

    from delora_tpu_torch.parallel import dist as pdist
    from delora_tpu_torch.training.state import make_param_ema
    from delora_tpu_torch.training.trainer import Trainer

    if device.type == "cuda":
        deterministic_kernels()
    step_losses: List[List[float]] = []
    trainer = _recording_steps(Trainer(config, device=device, run_name=run_name),
                               step_losses)
    if init_weights is not None:
        trainer.model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                       for k, v in init_weights.items()})
        trainer.ema = make_param_ema(config, trainer.model)
    resident = all(feed.tables is not None for feed in trainer.feeds.values())
    reset_kernel_launches()
    history = trainer.train(epochs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches_train = kernel_launches()
    saved = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    writes = trainer.ckpt.writes

    resumed = _recording_steps(Trainer(dict(config, checkpoint="latest", hbm_cache_scans=0),
                                       device=device, run_name=f"{run_name}-resume"),
                               step_losses)
    restored_equal = all(torch.equal(v.detach().cpu(), saved[k])
                         for k, v in resumed.model.state_dict().items())
    streamed = all(feed.loader is not None for feed in resumed.feeds.values())
    reset_kernel_launches()
    history += resumed.train(epochs + 1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"rank": pdist.rank(), "world": pdist.world_size(),
            "losses": [h["loss"] for h in history], "metrics": history,
            "writes": writes + resumed.ckpt.writes,
            "checkpoint_files": sorted(os.listdir(trainer.ckpt.directory)),
            "restored_equal": restored_equal, "start_epoch": resumed.start_epoch,
            "resident": resident, "streamed": streamed,
            "launches_train": launches_train, "launches_resume": kernel_launches(),
            "step_losses": step_losses}


def prepare_drive(device, config: Dict[str, Any], root: str, n_scans: int, rings: int,
                  azimuth_steps: int, seed: int = 0) -> int:
    """Write a synthetic drive of ``n_scans`` scans as a KITTI layout under
    ``<root>/raw`` (``data/synthetic.py``) and preprocess every dataset of
    ``config`` -> the scans written. It forks a pool for more than 8 scans,
    so run it in a process of its own (:func:`run_group` with one process)."""
    from delora_tpu_torch.data.preprocess import Preprocessor
    from delora_tpu_torch.data.synthetic import write_kitti_layout

    write_kitti_layout(os.path.join(root, "raw"), n_scans=n_scans, rings=rings,
                       azimuth_steps=azimuth_steps, seed=seed)
    pre = Preprocessor(config, device=device)
    return sum(pre.run_dataset(name) for name in config["datasets"])


def check_run(results: Sequence[Dict[str, Any]], epochs: int) -> None:
    """The checks of one run: its processes' losses identical, process 0
    alone wrote checkpoints, every process resumed at ``epochs`` with the
    saved weights."""
    for r in results[1:]:
        if r["losses"] != results[0]["losses"]:
            raise RuntimeError(f"processes disagree: {[x['losses'] for x in results]}")
    writes = [r["writes"] for r in results]
    if writes[0] < 1 or any(writes[1:]):
        raise RuntimeError(f"checkpoint files written by rank: {writes}")
    for r in results:
        if not r["restored_equal"] or r["start_epoch"] != epochs:
            raise RuntimeError(f"rank {r['rank']}: resumed at {r['start_epoch']}, weights "
                               f"restored {r['restored_equal']}")


def relative_drift(a: Sequence[float], b: Sequence[float]) -> float:
    """The largest |a - b| / |a| over the epochs."""
    return max(abs(x - y) / max(abs(x), 1e-12) for x, y in zip(a, b))


def compare(config: Dict[str, Any], workdir: str, nproc: int = 2, *,
            device: Optional[str] = None,
            backend: Optional[str] = None, epochs: int = 2, rtol: float = 1e-5,
            timeout: float = 600.0, threads: Optional[int] = None,
            init_weights: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The parent: :func:`train_run` in 1 process and in ``nproc`` (each run
    with its checkpoint and log directories emptied first), each checked by
    :func:`check_run`, their losses compared -> the verdict, with both runs'
    results. ``device`` as :func:`run_group`'s. Raises if a check fails or
    the drift passes ``rtol``."""
    runs = {}
    for n in (1, nproc):
        for key in ("checkpoint_dir", "log_dir"):
            shutil.rmtree(config[key], ignore_errors=True)
        kwargs = dict(config=config, epochs=epochs, run_name=f"mp{n}",
                      init_weights=init_weights)
        results = run_group(f"{MODULE}:train_run", n, kwargs,
                            workdir=os.path.join(workdir, f"run{n}"), device=device,
                            backend=backend, timeout=timeout, threads=threads)
        check_run(results, epochs)
        runs[n] = results
    drift = relative_drift(runs[1][0]["losses"], runs[nproc][0]["losses"])
    verdict = {"nproc": nproc, "device": device or "cuda", "epochs": epochs + 1,
               "epoch_losses_1proc": runs[1][0]["losses"],
               f"epoch_losses_{nproc}proc": runs[nproc][0]["losses"],
               "max_rel_drift": drift, "rtol": rtol, "ok": drift <= rtol, "runs": runs}
    if not verdict["ok"]:
        raise RuntimeError(f"{nproc} processes drift {drift:.3e} from 1 (rtol {rtol}): "
                           f"{verdict['epoch_losses_1proc']} vs "
                           f"{verdict[f'epoch_losses_{nproc}proc']}")
    return verdict


def smoke_config(root: str) -> Dict[str, Any]:
    """The command line's narrow profile: a drive of 9 scans, 16x64 images
    (16x128 for the normals), a one-block-a-stage model at 1/16 width, fp32,
    B = 2, unsupervised, 2 epochs on tables and one streamed after the
    resume, checkpoints every epoch."""
    from delora_tpu_torch.config import default_config

    return default_config({
        "datasets": ["kitti"],
        "kitti": {"training_identifiers": [0], "testing_identifiers": [0],
                  "vertical_cells": 16, "horizontal_cells": 64,
                  "horizontal_cells_preprocessing": 128, "max_points": 4096,
                  "neighborhood_side_length": [5, 7],
                  "data_path": os.path.join(root, "raw", "sequences"),
                  "preprocessed_path": os.path.join(root, "preprocessed"),
                  "pose_data_path": os.path.join(root, "raw", "poses")},
        "batch_size": 2, "learning_rate": 1e-4, "resnet_outputs": 32,
        "layers": [1, 1, 1, 1], "factor_fewer_resnet_channels": 16,
        "compute_dtype": "float32", "unsupervised_at_start": True,
        "visualize_images": False, "prewarm_cache": False,
        "checkpoint_dir": os.path.join(root, "ckpt"), "log_dir": os.path.join(root, "runs")})


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}")
    sub = ap.add_subparsers(dest="role")
    call = sub.add_parser("call", help="worker: run module:function in a group")
    call.add_argument("target")
    call.add_argument("--rank", type=int, required=True)
    call.add_argument("--world", type=int, required=True)
    call.add_argument("--port", type=int, required=True)
    call.add_argument("--device", required=True)
    call.add_argument("--backend", default=None)
    call.add_argument("--group", action="store_true",
                      help="join a group even of one process")
    call.add_argument("--threads", type=int, default=None)
    call.add_argument("--args", required=True)
    call.add_argument("--out", required=True)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="every process's device (default: process r on cuda:r)")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    if args.role == "call":
        _worker(args)
        return
    root = args.dir or tempfile.mkdtemp(prefix="delora_torch_mp_")
    config = smoke_config(root)
    if not os.path.isdir(config["kitti"]["preprocessed_path"]):
        run_group(f"{MODULE}:prepare_drive", 1,
                  dict(config=config, root=root, n_scans=9, rings=16, azimuth_steps=512),
                  workdir=os.path.join(root, "prepare"), device=args.device)
    verdict = compare(config, os.path.join(root, "work"), args.nproc, device=args.device,
                      backend=args.backend)
    verdict.pop("runs")
    print(json.dumps(verdict), flush=True)


if __name__ == "__main__":
    main()
