"""Checkpoints of the trainer, as ``torch.save`` files, with the reference's
names, cadence and embedded config.

The port of ``delora_tpu/training/checkpoint.py``. ``latest`` is overwritten
at every save; ``epoch_NNNNN`` is kept when the epoch is a multiple of
``keep_every``; ``save_named`` overwrites one named checkpoint (``best``)
with extra meta. A checkpoint is one file at ``<directory>/<name>`` holding
``{"state": ..., "meta": {"epoch", "loss", "parameters", ...}}``: the state is
what ``Trainer.state_dict`` returns (model, optimizer, schedule, and the EMA
and the dropout generator where the run has them), with tensors on the CPU;
``parameters`` is the run's config made JSON-safe. Files are written to a
temporary name and renamed, so a reader never sees half of one, and read with
``weights_only=True``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _json_safe(config: Mapping[str, Any]) -> Dict[str, Any]:
    def default(o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        return str(o)

    return json.loads(json.dumps(dict(config), default=default))


def _cpu(state):
    if torch.is_tensor(state):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_cpu(v) for v in state)
    return state


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint file -> ``{"state", "meta"}`` (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, keep_every: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep_every = keep_every
        os.makedirs(self.directory, exist_ok=True)

    def path(self, name: str) -> str:
        """The file of checkpoint ``name`` (a path is taken as it is)."""
        return os.path.join(self.directory, name)

    def _write(self, name: str, state, meta: Dict[str, Any]) -> str:
        target = self.path(name)
        tmp = target + ".tmp"
        torch.save({"state": _cpu(state), "meta": meta}, tmp)
        os.replace(tmp, target)
        return target

    @staticmethod
    def _meta(epoch: int, loss: float, config: Mapping[str, Any]) -> Dict[str, Any]:
        return {"epoch": int(epoch), "loss": float(loss), "parameters": _json_safe(config)}

    def save(self, state, epoch: int, loss: float, config: Mapping[str, Any]) -> None:
        """Overwrite ``latest``; keep a copy ``epoch_NNNNN`` on every
        ``keep_every``-th epoch."""
        latest = self._write("latest", state, self._meta(epoch, loss, config))
        if self.keep_every and epoch % self.keep_every == 0:
            durable = self.path(f"epoch_{epoch:05d}")
            shutil.copyfile(latest, durable + ".tmp")
            os.replace(durable + ".tmp", durable)

    def save_named(self, state, name: str, epoch: int, loss: float,
                   config: Mapping[str, Any], extra_meta: Optional[Dict[str, Any]] = None
                   ) -> None:
        """Overwrite the checkpoint ``name`` (for example ``best``), its meta
        extended by ``extra_meta``."""
        meta = self._meta(epoch, loss, config)
        meta.update(extra_meta or {})
        self._write(name, state, meta)

    def restore(self, name: str = "latest") -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """-> (state, meta) of the checkpoint ``name``: meta holds
        {epoch, loss, parameters} and any extra meta."""
        payload = load_checkpoint(self.path(name))
        return payload["state"], payload["meta"]

    @staticmethod
    def embedded_config(path: str) -> Optional[Dict[str, Any]]:
        """The config embedded in the checkpoint at ``path``; if there is no
        such file, the one of ``latest`` beside it; None if neither exists."""
        path = path.rstrip("/")
        if not os.path.isfile(path):
            path = os.path.join(os.path.dirname(path), "latest")
        if not os.path.isfile(path):
            return None
        return load_checkpoint(path)["meta"].get("parameters")


def deploy_weights(state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The weights to evaluate or serve from a trainer state: the parameter
    EMA's when the run tracked one, else the model's."""
    return state["ema"] if state.get("ema") is not None else state["model"]
