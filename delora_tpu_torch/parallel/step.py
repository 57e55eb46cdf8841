"""The state broadcast and the tables sharded over processes of data-parallel
training.

The port of ``delora_tpu/parallel/pjit_step.py``. The reference computes
each step on the global batch sharded over a mesh and lets XLA insert the
collectives; here every process of a ``torch.distributed`` group runs
``training/step.py::train_step`` on its share of the global batch, rows
``rank``, ``rank + world``, ... (``dist.BatchShard``, carried by
``StepConfig.shard``; the strided share that ``BatchLoader`` gives a shard),
and what the global program gets for free is rebuilt by hand:

- **gradients** are averaged over the group in one flat all-reduce before
  Adam (``BatchShard.mean_``): each process's loss is the mean of its pairs'
  per-pair means, so the mean over processes is the global mean, and every
  process applies the same update;
- **``quaternion_normalization: global``** divides by the norm of the whole
  global ``[B, 4]`` quaternion tensor: the model sums its squares over the
  group with a differentiable all-reduce (``BatchShard.sum``);
- **augmentation rotations and dropout masks** are drawn for the global
  batch from the generators every process seeds alike, and each process
  keeps its rows, so N processes draw what one would;
- **metrics** are averaged over the group and the counts
  (``placement_overflow_tiles``) summed (``BatchShard.reduce_metrics``);
  ``grad_norm`` is taken on the averaged gradients. Every process then holds
  the same values.

This module holds the rest: :func:`broadcast_state` (the counterpart of
``replicate_state``) and :class:`ShardedTables`, the port of
``shard_stacked_tables`` and of the on-device gather of
``make_sharded_scan_steps``: each process holds one contiguous block of the
stacked per-scan rows (padded to a multiple of the world size), and each step
every owner broadcasts the rows the global batch needs from its block.
Broadcast is the one exchange that NCCL and gloo (also with CUDA tensors,
where gloo has only broadcast, all-reduce and barrier) both give. The K-step
``lax.scan`` dispatch of the reference has no port: it amortizes the TPU's
dispatch round trip.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from delora_tpu_torch.parallel.dist import BatchShard, active, batch_shard
from delora_tpu_torch.training import step as single

# The twin of ``make_sharded_infer_step``: each pair's transform depends on
# its own pair only, so a process infers its share of a raw batch with the
# single-device step.
infer_step = single.infer_step


def _broadcast_(tensor: torch.Tensor, device: torch.device) -> None:
    """Broadcast ``tensor`` from rank 0 in place; a CPU tensor goes through
    ``device`` when the backend cannot send CPU tensors (NCCL)."""
    if tensor.device.type == "cpu" and dist.get_backend() == "nccl":
        staged = tensor.to(device)
        dist.broadcast(staged, 0)
        tensor.copy_(staged.cpu())
    else:
        dist.broadcast(tensor, 0)


@torch.no_grad()
def broadcast_state(model, optimizer, schedule=None, ema=None,
                    generators: Sequence[Optional[torch.Generator]] = ()) -> None:
    """Rank 0's weights, optimizer state (moments, counts, learning rates),
    schedule, EMA and generator states, sent to every other process (the
    counterpart of ``replicate_state``). Nothing without a process group."""
    if not active():
        return
    device = next(model.parameters()).device
    for tensor in model.state_dict().values():
        _broadcast_(tensor, device)
    for group in optimizer.param_groups:
        for p in group["params"]:
            for key in sorted(optimizer.state.get(p, {})):
                value = optimizer.state[p][key]
                if torch.is_tensor(value):
                    _broadcast_(value, device)
    shared = [[g["lr"] for g in optimizer.param_groups],
              None if schedule is None else schedule.state_dict()]
    dist.broadcast_object_list(shared, 0, device=device if dist.get_backend() == "nccl"
                               else None)
    for group, lr in zip(optimizer.param_groups, shared[0]):
        group["lr"] = lr
    if schedule is not None:
        schedule.load_state_dict(shared[1])
    if ema is not None:
        for tensor in ema.params:
            _broadcast_(tensor, device)
    for generator in generators:
        if generator is not None:
            state = generator.get_state()
            _broadcast_(state, device)
            generator.set_state(state)


class ShardedTables:
    """Stacked per-scan tables (leaves ``[S, ...]``) split over the group:
    this process holds rows ``rank * per`` .. ``(rank + 1) * per - 1`` on
    ``device``, ``per = ceil(S / world)``, the last block zero-padded; pad
    rows are never asked for. Leaves are numpy arrays."""

    def __init__(self, leaves: Sequence[np.ndarray], device: torch.device,
                 shard: Optional[BatchShard] = None):
        self.shard = shard or batch_shard()
        self.rows = int(leaves[0].shape[0])
        self.per = -(-self.rows // self.shard.count)
        self.device = device
        first = self.shard.index * self.per
        self.local = []
        for leaf in leaves:
            block = np.zeros((self.per,) + leaf.shape[1:], leaf.dtype)
            part = leaf[first:first + self.per]
            block[:len(part)] = part
            self.local.append(torch.from_numpy(block).to(device))

    def gather(self, needed: Sequence[np.ndarray], leaves: Sequence[int]
               ) -> List[torch.Tensor]:
        """Collective: ``needed[r]`` are the global rows process r needs
        (the same lists on every process) -> this process's rows of each of
        ``leaves``, in the order of ``needed[rank]``. Each owner broadcasts
        the needed rows of its block, packed into one byte buffer."""
        wanted = np.unique(np.concatenate([np.asarray(n, np.int64) for n in needed]))
        if wanted.size and (wanted[0] < 0 or wanted[-1] >= self.rows):
            raise IndexError(f"table rows {wanted[[0, -1]]} outside 0..{self.rows - 1}")
        owner = wanted // self.per
        tables = [self.local[i] for i in leaves]
        widths = [t[0].numel() * t.element_size() for t in tables]
        parts: List[List[torch.Tensor]] = [[] for _ in tables]
        for o in range(self.shard.count):
            rows = wanted[owner == o]
            if not rows.size:
                continue
            if o == self.shard.index:
                sel = torch.from_numpy(rows - o * self.per).to(self.device)
                buf = torch.cat([t[sel].reshape(len(rows), -1).view(torch.uint8)
                                 for t in tables], dim=1).contiguous()
            else:
                buf = torch.empty((len(rows), sum(widths)), dtype=torch.uint8,
                                  device=self.device)
            dist.broadcast(buf, o)
            offset = 0
            for slot, t, width in zip(parts, tables, widths):
                chunk = buf[:, offset:offset + width].contiguous().view(t.dtype)
                slot.append(chunk.reshape((len(rows),) + tuple(t.shape[1:])))
                offset += width
        pos = torch.from_numpy(np.searchsorted(wanted, np.asarray(needed[self.shard.index],
                                                                  np.int64))).to(self.device)
        return [torch.cat(slot)[pos] for slot in parts]
