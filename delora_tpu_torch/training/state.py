"""Optimizer of the training step: Adam with optax semantics, and the
parameter EMA.

The port of ``delora_tpu/training/state.py``'s ``effective_learning_rate``,
``make_optimizer``, ``track_param_ema``, ``ema_params`` and ``deploy_state``.
``optax.adam`` divides by ``sqrt(nu_hat) + eps`` with ``eps_root`` 0, which is
what ``torch.optim.Adam`` computes (b1 0.9, b2 0.999, eps 1e-8). The cosine
schedule is ``optax.cosine_decay_schedule``, evaluated, as optax does, at the
count of updates made before the current one: the first step runs at the full
rate. With ``ema_decay`` d > 0, :class:`ParamEma` keeps real copies of the
parameters and, after every optimizer step, ``ema <- d * ema + (1 - d) * p``
with the updated parameters, as ``track_param_ema`` (last in the optax chain)
sees ``params + updates``; :func:`deploy_model` is the model to evaluate or
serve.

Not ported: ``fused_adam`` (raises here; numerically the same update).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

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
    optimizer = torch.optim.Adam(params, lr=effective_learning_rate(config, global_batch_size),
                                 betas=(0.9, 0.999), eps=1e-8)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lr_factor(config))


class ParamEma:
    """Exponential moving average of a model's parameters, held as real
    copies on the parameters' device."""

    def __init__(self, model: torch.nn.Module, decay: float):
        self.decay = float(decay)
        named = [(k, p) for k, p in model.named_parameters()]
        self.names = [k for k, _ in named]
        self.params = [p.detach().clone() for _, p in named]

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        """Fold in the model's current (post-update) parameters."""
        live = [p.detach() for p in model.parameters()]
        torch._foreach_mul_(self.params, self.decay)
        torch._foreach_add_(self.params, live, alpha=1.0 - self.decay)


def make_param_ema(config, model: torch.nn.Module) -> Optional[ParamEma]:
    """The EMA of ``model``'s parameters when ``ema_decay`` > 0, else None
    (nothing allocated)."""
    decay = float(config.get("ema_decay", 0.0))
    return ParamEma(model, decay) if decay > 0.0 else None


def ema_params(ema: Optional[ParamEma]) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA parameters by name, or None if the EMA is off."""
    return None if ema is None else dict(zip(ema.names, ema.params))


def deploy_model(model: torch.nn.Module, ema: Optional[ParamEma]) -> torch.nn.Module:
    """The model to evaluate or serve: a copy in eval mode carrying the EMA
    weights when the EMA is tracked, else ``model`` itself."""
    if ema is None:
        return model
    deployed = copy.deepcopy(model).eval()
    deployed.load_state_dict(ema_params(ema))
    return deployed
