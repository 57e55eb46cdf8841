"""Exact 1-nearest-neighbour search: the kernel's wrapper and its plain version.

For every source point, the nearest valid target point of the same batch by

    d(s, t) = (|s|^2 + |t|^2) - 2 s.t,

with ``|x|^2 = fma(z, z, fma(y, y, x * x))`` and ``s.t = fma(sz, tz, fma(sy,
ty, sx * tx))`` in float32, each fma rounded once. That is the order of the
reference's kernel, ``delora_tpu/ops/pallas/nn_search.py::_nn_kernel``
(``s_sq + bias - 2 * cross``, its cross term a matmul), so the winners and
distances are bit-equal to ``nn_search_pallas`` on the CPU. The minimum starts
at 1e30 with index 0 and takes a candidate on strict ``<`` in index order:
ties go to the lower index, and a source with no valid target gets
``(0, 1e30)``. ``idx`` is int32 in ``[0, T - 1]``.

The CUDA kernel is ``delora_tpu_torch/csrc/nn_search.cu``; it replaces the TPU
kernel ``_nn_kernel`` as launched by ``_nn_search_single`` and
``_nn_search_batched``. The reference has two routes to the same exact
1-NN, chosen by ``use_pallas_nn`` (the Pallas kernel, or an XLA matmul
formula); the port has one, this search, and no backend knob. Nothing here
carries gradients: the search is detached, as in the reference.

A call on CUDA tensors is kept lean on the host, as the placement's: the
``ctypes`` function is configured once, the checks are attribute tests, the
stream is read as a raw pointer, and the kernel's scratch (packed targets)
and its per-source winner keys live in a cached workspace per (device,
stream) that the kernel leaves clean, so a call allocates only its outputs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from delora_tpu_torch.ops.cuda.build import load_library
from delora_tpu_torch.ops.exact import fma_exact, squared_distance

BIG = 1e30
_SIZE_LIMIT = 2**31 // 4
# Target slots one block of the kernel's count and pack passes covers
# (kChunk in csrc/nn_search.cu); it sizes the scratch.
_CHUNK = 2048


def _check(src, tgt, valid):
    if src.dim() != 3 or src.shape[-1] != 3 or tgt.dim() != 3 or tgt.shape[-1] != 3:
        raise ValueError(f"src and tgt must be [B, S, 3] and [B, T, 3], got "
                         f"{tuple(src.shape)}, {tuple(tgt.shape)}")
    if valid.shape != tgt.shape[:2] or tgt.shape[0] != src.shape[0]:
        raise ValueError(f"valid {tuple(valid.shape)} does not fit tgt {tuple(tgt.shape)}, "
                         f"src {tuple(src.shape)}")
    if src.dtype != torch.float32 or tgt.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"need float32 points and a bool mask; got {src.dtype}, {tgt.dtype}, "
                         f"{valid.dtype}")
    if not (src.device == tgt.device == valid.device):
        raise ValueError("src, tgt and valid must lie on one device")
    if tgt.shape[1] < 1:
        raise ValueError("the search needs at least one target slot")
    if max(src.shape[1], tgt.shape[1]) >= _SIZE_LIMIT:
        raise ValueError("sizes must fit in int32")


def _check_launch(src, tgt, valid):
    """What the kernel needs, as one chain of attribute tests: ranks, shapes,
    dtypes, one device, at least one target slot, sizes that fit in int32 and
    contiguity. On a failure :func:`_check` names the fault; what it passes
    is the contiguity."""
    ss, ts, dev = src.shape, tgt.shape, src.device
    if not (len(ss) == 3 and len(ts) == 3 and ss[2] == 3 and ts[2] == 3 and ts[0] == ss[0]
            and valid.shape == ts[:2] and src.dtype is torch.float32
            and tgt.dtype is torch.float32 and valid.dtype is torch.bool
            and tgt.device == dev and valid.device == dev
            and 0 < ts[1] < _SIZE_LIMIT and ss[1] < _SIZE_LIMIT
            and src.is_contiguous() and tgt.is_contiguous() and valid.is_contiguous()):
        _check(src, tgt, valid)
        raise ValueError("nn_search kernel needs contiguous inputs")


def scratch_bytes(batch: int, slots: int) -> int:
    """Bytes of the kernel's scratch for ``batch`` rows of ``slots`` target
    slots: packed targets (16 B a slot), their indices (4 B a slot), a count
    a row and one a chunk of slots (the layout ``nn_search_launch`` carves)."""
    return batch * slots * 20 + batch * 4 + batch * -(-slots // _CHUNK) * 4


def nn_search_plain(src, tgt, valid, chunk: int = 1 << 22
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the same arithmetic elementwise over the valid
    targets of each batch, in source chunks of about ``chunk`` pairs (no
    matmul: its summation order, and TF32 on the card, would move winners).
    ``[B, S, 3], [B, T, 3], [B, T] -> (idx [B, S] int32, sq [B, S])``."""
    _check(src, tgt, valid)
    B, S, _ = src.shape
    idx = torch.zeros(B, S, dtype=torch.int32, device=src.device)
    sq = torch.full((B, S), BIG, dtype=torch.float32, device=src.device)
    for b in range(B):
        sel = torch.nonzero(valid[b]).squeeze(1)
        if len(sel) == 0:
            continue
        t = tgt[b, sel]
        bias = squared_distance(t)
        step = max(1, chunk // len(sel))
        for lo in range(0, S, step):
            s = src[b, lo:lo + step]
            x, y, z = (c[:, None] for c in s.unbind(-1))
            cross = fma_exact(z, t[:, 2], fma_exact(y, t[:, 1], x * t[:, 0]))
            d = (squared_distance(s)[:, None] + bias) - 2.0 * cross
            m, j = d.min(dim=1)
            hit = m < BIG
            idx[b, lo:lo + step] = torch.where(hit, sel[j], 0).to(torch.int32)
            sq[b, lo:lo + step] = torch.where(hit, m, BIG)
    return idx, sq


def nn_search(src, tgt, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN ``[B, S, 3], [B, T, 3], [B, T] bool -> (idx [B, S] int32,
    sq [B, S] float32)`` (see the module docstring).

    On CUDA tensors it launches the kernel (and counts the call in
    ``nn_search.launches``); on CPU tensors it runs :func:`nn_search_plain`.
    """
    dev = src.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return nn_search_plain(src, tgt, valid)
        raise ValueError(f"nn_search runs on cuda or cpu, not {dev}")
    _check_launch(src, tgt, valid)
    B, S, _ = src.shape
    T = tgt.shape[1]
    index = dev.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    keys, scratch = _workspace(index, stream, B * S, scratch_bytes(B, T), dev)
    idx = torch.empty((B, S), dtype=torch.int32, device=dev)
    sq = src.new_empty((B, S))
    err = _launcher()(src.data_ptr(), tgt.data_ptr(), valid.data_ptr(), keys.data_ptr(),
                      scratch.data_ptr(), idx.data_ptr(), sq.data_ptr(), B, S, T, index,
                      stream)
    if err != 0:
        _workspaces.pop((index, stream), None)
        raise RuntimeError(f"nn_search kernel launch failed with CUDA error {err}")
    nn_search.launches += 1
    return idx, sq


nn_search.launches = 0

# (winner keys, scratch), one pair per (device index, raw stream). The keys
# are 64-bit words with every bit set (the empty key) between calls: the
# kernel's finishing pass resets each key it reads, so no call fills them.
# Calls on one stream run in order, so they can share the pair.
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(index: int, stream: int, keys_needed: int, scratch_needed: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """At least ``keys_needed`` empty keys and ``scratch_needed`` bytes of
    scratch for this device and stream; each grows on its own."""
    pair = _workspaces.get((index, stream))
    if pair is None or pair[0].numel() < keys_needed or pair[1].numel() < scratch_needed:
        keys, scratch = pair if pair is not None else (None, None)
        if keys is None or keys.numel() < keys_needed:
            keys = torch.full((keys_needed,), -1, dtype=torch.int64, device=device)
        if scratch is None or scratch.numel() < scratch_needed:
            scratch = torch.empty(scratch_needed, dtype=torch.uint8, device=device)
        pair = keys, scratch
        _workspaces[(index, stream)] = pair
    return pair


@functools.lru_cache(maxsize=None)
def _launcher():
    """``nn_search_launch`` of the built library, its argument types set once."""
    fn = load_library("nn_search").nn_search_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
