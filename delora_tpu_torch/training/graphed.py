"""The trainer's step as one replayed CUDA graph.

On a CUDA device ``Trainer.step`` hands its steps to :class:`StepGraphs`,
which replays the whole of ``training/step.py::update_step`` as one captured
CUDA graph: the forward in bf16 autocast, the detached warp and the packed
placement (``csrc/placement.cu``), the per-pixel affine, the window matcher
(``csrc/window_match.cu``), the ICP losses, the backward with the wrap-pad
both ways (``csrc/circular_pad.cu``), the global gradient norm, Adam and the
EMA. One launch from the host replaces the step's ~800; every kernel runs as
it does eagerly, inside the graph. The schedule steps after each replay, on
the host, filling Adam's device learning rate in place
(``training/state.py::make_optimizer``).

The graph engages where :func:`graphable` holds: on a CUDA device, outside a
process group (data parallelism stays eager), with a matcher that reads
nothing back to the host (not brute: its 1-NN wrapper's ``nonzero`` does),
and on a model with no Python hook, which a replay could not run. Graphs are
keyed by :func:`step_key`: the step's config, the batch's type, its leaves'
shapes and dtypes, and the model's train or eval mode.

A new key first takes ``WARMUP_STEPS`` eager steps on the capture stream,
real steps of the run (they settle cuDNN and cuBLAS, make the placement's
key workspace of that stream and Adam's state); the next step is captured and
replayed at once, so the run follows the eager trajectory. The capture
follows PyTorch's whole-network recipe: ``zero_grad(set_to_none=True)``
inside it, so the gradients live in the graph's memory pool; autocast's
weight cache off, so the bf16 casts of the weights are in the graph; the
dropout and augmentation generators registered with the graph, so their
draws advance at every replay as they do eagerly.

Inputs are one set of static slots a batch signature, shared by the
signature's graphs: each replay copies a batch's leaves into them. The
step's metrics are stacked into one vector inside the graph and cloned
after each replay, one device copy, so the epoch's single readback sees
every step.

A graph reads the model's parameters, Adam's state and rate, the EMA, the
slots and the placement's winner keys where they lie: change them in place
only. The placement keeps one key buffer a stream and replaces it when a
larger call comes, as a key of more pixels does in its warm-up on the
capture stream; so a graph holds every key buffer that was in use at its
capture (``ops/cuda/placement.py::workspaces``) and replays on a buffer
nothing else is handed. A graph whose tensors were replaced is dropped
before its next replay: Adam's state cleared or loaded (the identity of the
first parameter's first moment) or the model moved or replaced (its first
parameter and that parameter's address); ``Trainer.load_state_dict`` drops
every graph.

Each replay runs inside ``record_function("training.step_graph")`` and adds
to each kernel's launch counter (``ops/cuda/launches.py``) what the capture
recorded, so the counters advance by a step's launches whether it was
replayed or eager: a replay runs no wrapper to count them. These counts are
inferred from the capture; the benchmark's rooflines divide traced kernel
time by them, and ``chip_smoke.py`` holds the launches that a trace of its
training paths shows. ``counts`` holds the captures, the replays and the eager
steps (``Trainer.graph_counts``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from delora_tpu_torch.ops.cuda.launches import launch_counters
from delora_tpu_torch.ops.cuda.placement import workspaces
from delora_tpu_torch.parallel import dist as pdist
from delora_tpu_torch.training.step import StepConfig, train_step, update_step

# Eager steps of a new key on the capture stream before its capture.
WARMUP_STEPS = 2


def has_hooks(model: torch.nn.Module) -> bool:
    """Whether a Python hook would run in the model's forward or backward: a
    forward, forward-pre, backward or backward-pre hook on one of its modules
    or on every module, or a gradient hook on one of its parameters."""
    every = torch.nn.modules.module
    if (every._global_forward_hooks or every._global_forward_pre_hooks
            or every._global_backward_hooks or every._global_backward_pre_hooks):
        return True
    for m in model.modules():
        if m._forward_hooks or m._forward_pre_hooks or m._backward_hooks \
                or m._backward_pre_hooks:
            return True
    return any(p._backward_hooks or p._post_accumulate_grad_hooks for p in model.parameters())


def graphable(device: torch.device, cfg: StepConfig, model: torch.nn.Module) -> bool:
    """Whether ``Trainer.step`` replays a captured graph of the step rather
    than issuing it eagerly."""
    return (device.type == "cuda" and not pdist.active() and cfg.correspondence != "brute"
            and not has_hooks(model))


def signature(batch) -> Tuple:
    """Each leaf's shape and dtype."""
    return tuple((tuple(x.shape), x.dtype) for x in batch)


def step_key(batch, cfg: StepConfig, model: torch.nn.Module) -> Tuple:
    """What a captured step is kept under: a step of another key is another
    graph."""
    return cfg, type(batch), signature(batch), model.training


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    slots: Tuple[torch.Tensor, ...]
    metrics: torch.Tensor                       # the step's metrics, stacked
    names: Tuple[str, ...]
    launches: Tuple[Tuple[object, str, int], ...]   # (wrapper, counter, launches)
    params: Tuple[torch.nn.Parameter, ...]      # those with a gradient
    grads: Tuple[torch.Tensor, ...]             # theirs, in the graph's pool
    anchor_ptr: int                             # the first parameter's address
    moment: torch.Tensor                        # its first moment in Adam
    workspaces: Tuple[torch.Tensor, ...]        # the placement's key buffers


class StepGraphs:
    """The captured steps of one trainer (see the module docstring): reads the
    trainer's ``device``, ``model``, ``optimizer``, ``schedule``, ``ema``,
    ``dropout_generator`` and ``augment_generator`` at each step."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.counts = {"captures": 0, "replays": 0, "eager": 0}
        self._graphs: Dict[Tuple, _Graph] = {}
        self._slots: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
        self._warm: Dict[Tuple, int] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def drop(self) -> None:
        """Forget every graph and warm-up: the next step of each key warms
        up and captures anew."""
        self._graphs.clear()
        self._warm.clear()

    def step(self, batch, cfg: StepConfig) -> Dict[str, torch.Tensor]:
        """One train step: a replay of the key's graph, captured first when
        the key has warmed up, else an eager warm-up step."""
        t = self.trainer
        key = step_key(batch, cfg, t.model)
        graph = self._graphs.get(key)
        if graph is not None and not self._current(graph):
            self.drop()
            graph = None
        if graph is None:
            if self._warm.get(key, 0) < WARMUP_STEPS or self._moment() is None:
                return self._warm_up(key, batch, cfg)
            graph = self._graphs[key] = self._capture(batch, cfg)
        return self._replay(graph, batch)

    # ---- internals ----------------------------------------------------------

    def _anchor(self) -> torch.nn.Parameter:
        return next(self.trainer.model.parameters())

    def _moment(self) -> Optional[torch.Tensor]:
        """Adam's first moment of the model's first parameter, if made."""
        return self.trainer.optimizer.state.get(self._anchor(), {}).get("exp_avg")

    def _current(self, graph: _Graph) -> bool:
        moment = self._moment()
        return (moment is graph.moment and moment is not None
                and self._anchor().data_ptr() == graph.anchor_ptr)

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.trainer.device)
        return self._stream

    def _warm_up(self, key: Tuple, batch, cfg: StepConfig) -> Dict[str, torch.Tensor]:
        """One eager step on the capture stream, ordered after and before the
        current stream's work."""
        t = self.trainer
        stream = self._capture_stream()
        current = torch.cuda.current_stream(t.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = train_step(t.model, t.optimizer, batch, cfg, t.schedule, t.ema,
                             t.dropout_generator, t.augment_generator)
        current.wait_stream(stream)
        self._warm[key] = self._warm.get(key, 0) + 1
        self.counts["eager"] += 1
        return out

    def _capture(self, batch, cfg: StepConfig) -> _Graph:
        """Capture :func:`update_step` on the slots of ``batch``'s signature
        (made here if new, and filled with ``batch``); nothing runs until
        the graph's first replay."""
        t = self.trainer
        kind = type(batch)
        slots = self._slots.get((kind, signature(batch)))
        if slots is None:
            slots = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in batch)
            self._slots[kind, signature(batch)] = slots
        for leaf, slot in zip(batch, slots):
            slot.copy_(leaf)
        graph = torch.cuda.CUDAGraph()
        for generator in (t.dropout_generator, t.augment_generator):
            if generator is not None:
                graph.register_generator_state(generator)
        counters = launch_counters().values()
        before = [getattr(w, attr) for w, attr in counters]
        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        try:
            with torch.cuda.graph(graph, stream=self._capture_stream()):
                metrics = update_step(t.model, t.optimizer, kind(*slots), cfg, t.ema,
                                      t.dropout_generator, t.augment_generator)
                stacked = torch.stack(list(metrics.values()))
        finally:
            torch.set_autocast_cache_enabled(cache)
        # The capture launched nothing: each replay adds what it recorded.
        launches = []
        for (w, attr), n in zip(counters, before):
            if getattr(w, attr) != n:
                launches.append((w, attr, getattr(w, attr) - n))
                setattr(w, attr, n)
        params = tuple(p for p in t.model.parameters() if p.grad is not None)
        self.counts["captures"] += 1
        return _Graph(graph, slots, stacked, tuple(metrics), tuple(launches), params,
                      tuple(p.grad for p in params), self._anchor().data_ptr(),
                      self._moment(), workspaces())

    def _replay(self, graph: _Graph, batch) -> Dict[str, torch.Tensor]:
        for leaf, slot in zip(batch, graph.slots):
            slot.copy_(leaf)
        with record_function("training.step_graph"):
            graph.graph.replay()
        for w, attr, n in graph.launches:
            setattr(w, attr, getattr(w, attr) + n)
        if self.trainer.schedule is not None:
            self.trainer.schedule.step()
        if graph.params and graph.params[0].grad is not graph.grads[0]:
            # An eager step of another key replaced them since.
            for p, grad in zip(graph.params, graph.grads):
                p.grad = grad
        self.counts["replays"] += 1
        return dict(zip(graph.names, graph.metrics.clone().unbind()))
