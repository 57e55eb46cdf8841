"""Training traffic: whole epochs of ``Trainer.train_epoch`` over one drive
held in the trainer's device tables, the trainer's own epoch order.

Set-up builds one ``Trainer`` over the drive (``scans`` of the configuration,
ray-cast from the seed), loads the benchmark's weights into it and runs
``warmup_epochs`` epochs; the first ``checked_steps`` steps of the first are
the ones the reference follows (their loss, the first gradient as Adam holds
it, the weights' change). The window then runs epochs until ``--seconds``
have passed, each ending in the trainer's one readback. A step fails when a
loss or metric it returned is not finite.
"""

from __future__ import annotations

import gc
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, scenes, trace
from portbench.context import Context, log
from portbench.reference import compare, model, train as ref_train
from portbench.roofline import peaks
from portbench.weights import sub_seed

BETA1 = ref_train.BETAS[0]


class Capture:
    """Wraps ``trainer.step`` through the first steps of set-up: keeps the
    first gradient (Adam's first moment after one step, over 1 - b1) and the
    weights after the last checked step. ``fault`` plants a fault in the
    program (``half_batch``: the step sees the first half of its batch;
    ``unchanged``: the optimizer never steps)."""

    def __init__(self, trainer, steps: int, fault=None):
        self.trainer, self.steps, self.fault, self.n = trainer, steps, fault, 0
        self.first_grad = self.after = None
        self.poses: List[torch.Tensor] = []
        if fault == "unchanged":
            trainer.optimizer.step = lambda *a, **k: None
        trainer.step = self.step
        self.hook = trainer.model.register_forward_hook(self.forward)

    def forward(self, module, inputs, output):
        """The step's transforms as the network gave them (translation and
        quaternion), built here into [B, 4, 4]."""
        translation, quat = output
        self.poses.append(model.transform(translation.detach().float(), quat.detach().float()))

    def step(self, batch, cfg):
        t = self.trainer
        if self.fault == "half_batch":
            batch = type(batch)(*(x[: x.shape[0] // 2] for x in batch))
        out = type(t).step(t, batch, cfg)
        self.n += 1
        named = list(t.model.named_parameters())
        if self.n == 1:
            self.first_grad = {k: t.optimizer.state[p]["exp_avg"].detach() / (1 - BETA1)
                               if "exp_avg" in t.optimizer.state.get(p, {})
                               else torch.zeros_like(p) for k, p in named}
        if self.n == self.steps:
            self.after = {k: p.detach().clone() for k, p in named}
            self.hook.remove()
        return out

    def release(self) -> None:
        del self.trainer.step
        self.hook.remove()


def setup(ctx: Context) -> SimpleNamespace:
    from delora_tpu_torch.training.trainer import Trainer

    cfg = ctx.program_config()
    sensor = scenes.Sensor.from_config(ctx.config["sensor"])
    n = int(ctx.config["scans"])
    drive = scenes.generate(ctx.config["scene"], sensor, n, ctx.seed, ctx.device)
    log(f"generator: {ctx.config['scene']} {drive.stats(sensor.beams * sensor.azimuth_steps)} "
        f"at {ctx.elapsed():.3f} s")
    _release_generator(ctx)
    w0 = ctx.weights()
    trainer = Trainer(cfg, sequences=[list(zip(drive.points, drive.normals))], device=ctx.device,
                      dataset=ctx.dataset,
                      generator=torch.Generator().manual_seed(sub_seed(ctx.seed, 3)))
    trainer.model.load_state_dict(w0)
    log(f"trainer built at {ctx.elapsed():.3f} s (its own set-up {trainer.setup_seconds:.3f} s: "
        f"model, {n} scans' artifacts, tables)")
    feed = trainer.feeds[ctx.dataset]
    if not (np.array_equal(feed.pair_target, np.arange(n - 1))
            and np.array_equal(feed.pair_source, np.arange(1, n))):
        raise RuntimeError("the trainer does not pair consecutive scans of the drive")
    checked = int(ctx.traffic["checked_steps"])
    capture = Capture(trainer, checked, ctx.variant)
    epochs = int(ctx.traffic["warmup_epochs"])
    for e in range(epochs):
        trainer.train_epoch(e)
        if e == 0:
            losses = [float(x) for x in trainer.last_steps["loss"][:checked]]
    capture.release()
    B = trainer.batch_size
    order = trainer.epoch_indices(0).reshape(-1, B)[:checked]
    log(f"{epochs} warm-up epoch(s) of {len(trainer.epoch_indices(0)) // B} steps, B={B}, done "
        f"at {ctx.elapsed():.3f} s")
    return SimpleNamespace(trainer=trainer, drive=drive, capture=capture, losses=losses,
                           order=order, epoch=epochs, w0=w0)


def _release_generator(ctx: Context) -> None:
    """The ray-cast's scratch memory goes back, and the peak counts from
    here: ``memory_peak_bytes`` is the program's."""
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)


def _failed(last_steps: Dict[str, np.ndarray]) -> int:
    ok = np.ones(len(next(iter(last_steps.values()))), bool)
    for v in last_steps.values():
        ok &= np.isfinite(v)
    return int((~ok).sum())


def _epoch(st) -> Dict[str, float]:
    m = st.trainer.train_epoch(st.epoch)
    st.epoch += 1
    st.failed += _failed(st.trainer.last_steps)
    return m


def window(ctx: Context, st, rec) -> None:
    import time

    t0 = time.perf_counter()
    rec.setup_s = t0 - ctx.t_start
    st.failed, steps, first = 0, 0, st.epoch
    while True:
        steps += _epoch(st)["steps"]
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    rec.window_s = time.perf_counter() - t0
    rec.steps, rec.pairs = steps, steps * st.trainer.batch_size
    rec.attempted, rec.failed = steps, st.failed
    spec = st.trainer.feeds[ctx.dataset].spec
    rec.kind = "train"
    rec.flops = flops.train_step_flops(ctx.arch, st.trainer.batch_size, spec.height, spec.width)
    rec.shapes = {"batch": st.trainer.batch_size, "height": spec.height, "width": spec.width,
                  "cap": min(ctx.max_points, spec.height * spec.width),
                  "window": tuple(ctx.config["training"]["projective_window"])}
    if ctx.device.type == "cuda":
        rec.peaks = peaks(torch.cuda.get_device_name(ctx.device))
    log(f"window: {st.epoch - first} epochs, {steps} steps in {rec.window_s:.3f} s")


def _launches():
    from delora_tpu_torch.ops.cuda.placement import placement
    from delora_tpu_torch.ops.cuda.window_match import window_match

    return {"placement_packed": placement.launches_packed, "window_match": window_match.launches}


def span(ctx: Context, st, rec) -> None:
    """The traced span: ``trace_epochs`` more epochs under the profiler, then
    the model's forward and backward alone on one batch (device time a call)."""
    from torch.profiler import record_function

    from delora_tpu_torch.training.step import forward_pose

    before = _launches()

    def epochs():
        with record_function("portbench.window"):
            for _ in range(int(ctx.traffic["trace_epochs"])):
                _epoch(st)

    rec.trace, _ = trace.profile(epochs, f"{ctx.cell.name}-{ctx.seed}")
    rec.launches = {k: v - before[k] for k, v in _launches().items()}
    t = st.trainer
    dev = ctx.device
    order = t.epoch_indices(0).reshape(-1, t.batch_size)[0]
    feed = t.feeds[ctx.dataset]
    batch = t.batch(torch.from_numpy(feed.pair_target[order]).to(dev),
                    torch.from_numpy(feed.pair_source[order]).to(dev))
    calls = int(ctx.traffic["model_profile_calls"])

    def fwd_bwd():
        for _ in range(calls):
            t.model.zero_grad(set_to_none=True)
            forward_pose(t.model, batch.image_1, batch.image_2).square().sum().backward()

    fwd_bwd()
    model_trace, _ = trace.profile(fwd_bwd, f"{ctx.cell.name}-{ctx.seed}-model")
    rec.model_device_ms = sum(e.end - e.start for e in model_trace.device) * 1e3 / calls
    t.model.zero_grad(set_to_none=True)


def outputs_kept(ctx: Context, st) -> SimpleNamespace:
    """The program's readings for the check, the trainer kept."""
    cap = st.capture
    return SimpleNamespace(losses=st.losses, poses=cap.poses, first_grad=cap.first_grad,
                           change={k: cap.after[k] - st.w0[k] for k in cap.after},
                           order=st.order, drive=st.drive)


def outputs(ctx: Context, st) -> SimpleNamespace:
    """The program's readings for the check; the trainer is let go."""
    out = outputs_kept(ctx, st)
    st.trainer = st.capture = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _batches(ctx: Context, out) -> List:
    scans: Dict[int, ref_train.Scan] = {}

    def scan(i):
        if i not in scans:
            d = out.drive
            scans[i] = ref_train.prepare(torch.from_numpy(d.points[i]).to(ctx.device),
                                         torch.from_numpy(d.normals[i]).to(ctx.device),
                                         ctx.spec, ctx.max_points)
        return scans[i]

    return [[(scan(int(p)), scan(int(p) + 1)) for p in chunk] for chunk in out.order]


def reference(ctx: Context, out, quant=None, nhwc: bool = False) -> SimpleNamespace:
    """The reference's first steps on the same pairs from the same weights,
    following the run's transforms (``reference/train.py::follow``); with
    ``quant``, the control: the reference in the precision below the
    configuration's, on its own transforms, in the program's place; with
    ``nhwc``, the same in bfloat16 with NHWC activations (calibration: another
    sound computation of the configuration)."""
    ref_train.check_config(ctx.config["training"])
    tc = ctx.config["training"]
    own = quant is not None or nhwc
    ref = ref_train.follow(ctx.weights(), _batches(ctx, out), ctx.spec, ctx.arch,
                           tuple(tc["projective_window"]), float(tc["learning_rate"]), quant,
                           given=None if own else out.poses,
                           autocast=torch.bfloat16 if nhwc else None, channels_last=nhwc)
    return SimpleNamespace(losses=ref.losses, poses=ref.poses, rounded=ref.rounded,
                           first_grad=ref.first_grad, change=ref.change, order=out.order,
                           drive=out.drive)


def compare_outputs(subject, ref) -> Dict[str, float]:
    return compare.training(subject, ref)


def rerun(ctx: Context, st, fault=None) -> SimpleNamespace:
    """The first steps again from the benchmark's weights and a fresh Adam,
    with ``fault`` planted (calibration)."""
    t = st.trainer
    t.model.load_state_dict(st.w0)
    t.optimizer.state.clear()
    checked = int(ctx.traffic["checked_steps"])
    cap = Capture(t, checked, fault)
    t.train_epoch(0)
    cap.release()
    if fault == "unchanged":
        del t.optimizer.step
    return SimpleNamespace(losses=[float(x) for x in t.last_steps["loss"][:checked]],
                           poses=cap.poses, first_grad=cap.first_grad,
                           change={k: cap.after[k] - st.w0[k] for k in cap.after},
                           order=st.order, drive=st.drive)
