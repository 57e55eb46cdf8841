"""Optimizer of the training step: Adam with optax semantics.

The port of ``delora_tpu/training/state.py``'s ``effective_learning_rate`` and
``make_optimizer``. ``optax.adam`` divides by ``sqrt(nu_hat) + eps`` with
``eps_root`` 0, which is what ``torch.optim.Adam`` computes (b1 0.9, b2 0.999,
eps 1e-8). The cosine schedule is ``optax.cosine_decay_schedule``, evaluated,
as optax does, at the count of updates made before the current one: the
first step runs at the full rate.

Not ported: the parameter EMA (``ema_decay > 0``; the config refuses it) and
``fused_adam`` (raises here).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch


def effective_learning_rate(config, global_batch_size: int) -> float:
    """Linear-scaling rule: lr * global_batch / base_batch (pod recipe)."""
    lr = float(config["learning_rate"])
    if config.get("lr_scaling", "none") == "linear":
        lr = lr * global_batch_size / float(config.get("lr_scaling_base_batch", 32))
    return lr


def lr_factor(config) -> Callable[[int], float]:
    """The schedule as a factor on the effective rate, by update count."""
    if str(config.get("lr_schedule", "constant")) != "cosine":
        return lambda count: 1.0
    decay_steps = int(config["lr_decay_steps"])
    if decay_steps <= 0:
        raise ValueError(f"lr_decay_steps must be positive, got {decay_steps}")
    alpha = float(config.get("lr_min_ratio", 0.1))

    def factor(count: int) -> float:
        count = min(count, decay_steps)
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha

    return factor


def make_optimizer(config, params: Iterable[torch.nn.Parameter],
                   global_batch_size: int) -> Tuple[torch.optim.Adam,
                                                    torch.optim.lr_scheduler.LambdaLR]:
    """-> (Adam, its schedule). Call ``schedule.step()`` after every
    ``optimizer.step()``."""
    if config.get("fused_adam", False):
        raise NotImplementedError("fused_adam is not ported: the port runs per-tensor Adam")
    if float(config.get("ema_decay", 0.0)) > 0.0:
        raise NotImplementedError("the parameter EMA (ema_decay > 0) is not ported yet")
    optimizer = torch.optim.Adam(params, lr=effective_learning_rate(config, global_batch_size),
                                 betas=(0.9, 0.999), eps=1e-8)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lr_factor(config))
