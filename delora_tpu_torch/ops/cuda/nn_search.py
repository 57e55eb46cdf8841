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
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from delora_tpu_torch.ops.cuda.build import load_library
from delora_tpu_torch.ops.cuda.window_match import fma_exact, squared_distance

BIG = 1e30




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
    if max(src.shape[1], tgt.shape[1]) >= 2**31 // 4:
        raise ValueError("sizes must fit in int32")


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

    On CUDA tensors it launches the kernel (and counts the launch in
    ``nn_search.launches``); on CPU tensors it runs :func:`nn_search_plain`.
    """
    if src.device.type == "cpu":
        return nn_search_plain(src, tgt, valid)
    if src.device.type != "cuda":
        raise ValueError(f"nn_search runs on cuda or cpu, not {src.device}")
    _check(src, tgt, valid)
    if not (src.is_contiguous() and tgt.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nn_search kernel needs contiguous inputs")
    B, S, _ = src.shape
    T = tgt.shape[1]
    dev = src.device
    packed = torch.empty(B, T, 4, dtype=torch.float32, device=dev)
    orig = torch.empty(B, T, dtype=torch.int32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    idx = torch.empty(B, S, dtype=torch.int32, device=dev)
    sq = torch.empty(B, S, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.nn_search_launch(
            src.data_ptr(), tgt.data_ptr(), valid.data_ptr(), packed.data_ptr(),
            orig.data_ptr(), count.data_ptr(), idx.data_ptr(), sq.data_ptr(), B, S, T,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nn_search kernel launch failed with CUDA error {err}")
    nn_search.launches += 1
    return idx, sq


nn_search.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("nn_search")
    fn = lib.nn_search_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
