"""Process groups of data-parallel training: one process a device over
``torch.distributed``.

The port of ``delora_tpu/parallel/mesh.py``. The reference builds a 1-D
``data`` mesh over its devices and lets XLA place the collectives; here each
process drives one device, holds a copy of the model, and takes its share of
every global batch (``training/step.py`` with ``StepConfig.shard``).
:func:`initialize_distributed` joins the process group, as
``initialize_multihost`` does, and is a no-op for a single process. Its
rank, world size and rendezvous come from the arguments, else from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``). The backend is the caller's: by default
NCCL for a CUDA device and gloo for the CPU, never switched behind the
caller's back; a failed rendezvous raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, NamedTuple, Optional, Union

import torch
import torch.distributed as dist

from delora_tpu_torch import resolve_device

# Step metrics summed over the group; every other metric is averaged.
SUMMED_METRICS = ("placement_overflow_tiles",)


def world_size() -> int:
    """Processes in the group (1 when no group is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 when no group is initialized)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of this process: ``device`` as given, except that a CUDA
    device without an index (and the default, CUDA) becomes
    ``cuda:LOCAL_RANK``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(device)


def default_backend(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def active() -> bool:
    """Whether a process group is initialized: the trainer and the step
    then take the data-parallel path (also in a group of one)."""
    return dist.is_initialized()


def initialize_distributed(backend: Optional[str] = None, *,
                           device: Optional[Union[str, torch.device]] = None,
                           rank: Optional[int] = None, world_size: Optional[int] = None,
                           init_method: Optional[str] = None, timeout_s: float = 600.0,
                           single_process_group: bool = False) -> Optional[torch.device]:
    """Join the process group -> this process's device, or None for a single
    process (``world_size``, else ``WORLD_SIZE``, at most 1), where nothing
    happens unless ``single_process_group`` asks for a group of one (which
    runs the data-parallel code path alone). ``rank`` defaults to ``RANK``;
    ``init_method`` to ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``);
    ``device`` to :func:`process_device`'s; ``backend`` to
    :func:`default_backend` of the device. A CUDA device becomes the
    process's current device before the rendezvous."""
    world = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else int(world_size)
    if world <= 1 and not single_process_group:
        return None
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    device = process_device(device)
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or default_backend(device),
                            init_method=init_method or "env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def shutdown() -> None:
    """Leave the process group, if one is initialized."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every process of the group (nothing for one process)."""
    if world_size() > 1:
        dist.barrier()


class BatchShard(NamedTuple):
    """This process's share of a global batch: rows ``index``,
    ``index + count``, ... (the strided share that ``BatchLoader`` gives a
    shard). Carried by ``StepConfig.shard``: the step draws the augmentation
    rotations for the global batch and keeps its rows, averages the
    gradients and the metrics over the group; the model draws its dropout
    masks for the global batch and keeps its rows, and sums the
    quaternions' squares over the group for ``quaternion_normalization:
    global``."""

    index: int
    count: int

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a global-batch tensor ``x``."""
        return x[self.index::self.count]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, with the gradient of that sum
        (the backward pass sums the incoming gradients over the group)."""
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x)

    def mean_(self, tensors: List[torch.Tensor]) -> None:
        """Each tensor replaced, in place, by its mean over the group: one
        flat all-reduce. A channels-last tensor (a convolution's gradient on
        the card) goes in memory order, through its NHWC view, so it is
        neither transposed nor copied twice; every process holds its tensors
        in the same layouts."""
        views = [t.permute(0, 2, 3, 1) if t.dim() == 4 and not t.is_contiguous() else t
                 for t in tensors]
        flat = torch.cat([v.reshape(-1) for v in views])
        dist.all_reduce(flat)
        flat.div_(self.count)
        offset = 0
        for v in views:
            v.copy_(flat[offset:offset + v.numel()].view_as(v))
            offset += v.numel()

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step metrics averaged over the group, :data:`SUMMED_METRICS`
        summed: one all-reduce."""
        names = list(metrics)
        vec = torch.stack([metrics[k].detach().to(torch.float32) for k in names])
        dist.all_reduce(vec)
        scale = torch.tensor([1.0 if k in SUMMED_METRICS else 1.0 / self.count
                              for k in names], device=vec.device)
        vec = vec * scale
        return {k: vec[i] for i, k in enumerate(names)}


def batch_shard() -> BatchShard:
    """This process's :class:`BatchShard` of the group."""
    return BatchShard(rank(), world_size())
