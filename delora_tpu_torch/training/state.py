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

``fused_adam`` (the reference's ``optax.flatten(adam)``) computes the same
numbers as per-leaf Adam, so it runs the same update here: torch's foreach
Adam, not its ``fused=True`` kernel.
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
    ``optimizer.step()``.

    Parameters on a CUDA device get the Adam a CUDA graph can capture
    (``capturable``: its step counts and bias corrections on the device) and a
    0-d float32 learning rate on the device, which the schedule fills in place,
    so a replayed step reads the rate of its own update; eager steps on the
    card run the same Adam. On the CPU the rate is a float and Adam the
    default one."""
    params = list(params)
    lr = effective_learning_rate(config, global_batch_size)
    capturable = bool(params) and params[0].device.type == "cuda"
    if capturable:
        lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 capturable=capturable)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lr_factor(config))


def fill_rate(live, value):
    """The rate ``value`` (a float or a 0-d tensor on any device) in the kind
    of ``live``: filled into the tensor ``live``, else a float."""
    if torch.is_tensor(live):
        return live.fill_(float(value))
    return float(value)


def load_optimizer_state(optimizer: torch.optim.Adam, schedule, optimizer_state,
                         schedule_state) -> None:
    """Load an optimizer's and its schedule's saved states into ``optimizer``
    and ``schedule`` of :func:`make_optimizer`, each keeping its own kind:
    a capturable Adam its device rate tensors (filled with the saved rates)
    and its step counts on the device, the CPU's float rates and host counts.
    So a checkpoint saved on the card resumes on the CPU and back, and a
    captured step keeps reading the tensors it captured. ``optimizer_state``
    None loads the schedule alone."""
    kinds = [(g["capturable"], g["lr"], g.get("initial_lr")) for g in optimizer.param_groups]
    bases = list(schedule.base_lrs)
    if optimizer_state is not None:
        optimizer.load_state_dict(optimizer_state)
    schedule.load_state_dict(schedule_state)
    schedule.base_lrs = [fill_rate(b, s) for b, s in zip(bases, schedule.base_lrs)]
    for group, (capturable, lr, initial) in zip(optimizer.param_groups, kinds):
        group["capturable"] = capturable
        group["lr"] = fill_rate(lr, group["lr"])
        if initial is not None:
            group["initial_lr"] = fill_rate(initial, group["initial_lr"])
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(p.device if capturable else "cpu")


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
