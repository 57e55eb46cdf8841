"""Dense winner placement: the kernel's wrapper and its plain version.

Given per-point pixel ids, ranges and payload values, build the image in which
each pixel holds its winner's payload and (unless ``append_range`` is False)
its range. Empty pixels are zero. Two winner rules:

- exact (``packed=False``): the point with the smallest range, and among
  equal ranges the lowest index (the stable (pixel, range) sort of
  ``delora_tpu/ops/projection.py::project_compact_exact``);
- packed (``packed=True``): the stable sort on ``pix << 16 | f32_bits(r) >> 16``
  of ``project_image_packed`` (:319-322): the lowest index among the points
  whose ranges agree with the smallest in the top 16 bits. It is not the
  exact rule's winner when two ranges of one pixel differ below that.

The CUDA kernel is ``delora_tpu_torch/csrc/placement.cu``; it replaces the TPU
kernel ``delora_tpu/ops/pallas/placement.py::placement_pallas``. A call on
CUDA tensors is kept lean on the host: the ``ctypes`` function is configured
once, the checks are attribute tests, the stream is read as a raw pointer,
and the winner keys live in a cached workspace per (device, stream) that the
kernel leaves clean, so a call allocates only its output and makes at most
two launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from delora_tpu_torch.ops.cuda.build import load_library

# The packed rule's 32-bit key holds a point index in its low 16 bits.
PACKED32_MAX_N = 1 << 16
_INT32_LIMIT = 1 << 31


def _check(pix, r, vals, height, width):
    if pix.dim() != 2 or r.shape != pix.shape:
        raise ValueError(f"pix and r must be [B, N], got {tuple(pix.shape)}, {tuple(r.shape)}")
    if vals.dim() != 3 or vals.shape[:2] != pix.shape:
        raise ValueError(f"vals must be [B, N, C], got {tuple(vals.shape)}")
    if pix.dtype != torch.int32 or r.dtype != torch.float32 or vals.dtype != torch.float32:
        raise ValueError(
            f"need pix int32, r and vals float32; got {pix.dtype}, {r.dtype}, {vals.dtype}"
        )
    if not (pix.device == r.device == vals.device):
        raise ValueError("pix, r and vals must lie on one device")
    if height <= 0 or width <= 0:
        raise ValueError(f"bad image size {height}x{width}")
    if max(pix.shape[0], pix.shape[1], vals.shape[2] + 1, height * width) >= _INT32_LIMIT:
        raise ValueError("sizes must fit in int32")


def _check_launch(pix, r, vals, height, width):
    """What the kernel needs, as one chain of attribute tests: ranks, shapes,
    dtypes, one device, contiguity and sizes that fit in int32. On a failure
    :func:`_check` names the fault; what it passes is the contiguity."""
    ps, vs, dev = pix.shape, vals.shape, pix.device
    if not (len(vs) == 3 and vs[:2] == ps and r.shape == ps and pix.dtype is torch.int32
            and r.dtype is torch.float32 and vals.dtype is torch.float32
            and r.device == dev and vals.device == dev
            and pix.is_contiguous() and r.is_contiguous() and vals.is_contiguous()
            and 0 < height and 0 < width and height * width < _INT32_LIMIT
            and ps[0] < _INT32_LIMIT and ps[1] < _INT32_LIMIT and vs[2] + 1 < _INT32_LIMIT):
        _check(pix, r, vals, height, width)
        raise ValueError("placement kernel needs contiguous inputs")


def key_bits(packed: bool, n: int) -> int:
    """Width of the kernel's winner keys for ``n`` points a batch row: 32 for
    the packed rule when every point index fits in 16 bits, else 64."""
    return 32 if packed and n <= PACKED32_MAX_N else 64


def _packed_range_key(r: torch.Tensor) -> torch.Tensor:
    """The top 16 bits of each f32 range, as the unsigned ``bits >> 16``."""
    return ((r.view(torch.int32) >> 16) & 0xFFFF).to(torch.int64)


def placement_plain(pix, r, vals, height: int, width: int, packed: bool = False,
                    append_range: bool = True) -> torch.Tensor:
    """Plain PyTorch version: stable sort by (pixel, range key), first of each
    pixel's run wins, one scatter. ``[B, N]``, ``[B, N]``, ``[B, N, C]`` ->
    ``[B, H, W, C + append_range]`` float32."""
    _check(pix, r, vals, height, width)
    B, N = pix.shape
    C = vals.shape[-1]
    hw = height * width
    if packed:
        key = pix.to(torch.int64) * 65536 + _packed_range_key(r)
        order = torch.sort(key, dim=-1, stable=True).indices
    else:
        order = torch.sort(r, dim=-1, stable=True).indices
        order = torch.gather(order, 1, torch.sort(torch.gather(pix, 1, order), dim=-1,
                                                  stable=True).indices)
    pix_s = torch.gather(pix, 1, order)
    first = torch.ones_like(pix_s, dtype=torch.bool)
    first[:, 1:] = pix_s[:, 1:] != pix_s[:, :-1]
    first &= (pix_s >= 0) & (pix_s < hw)
    payload = torch.cat([vals, r[..., None]], dim=-1) if append_range else vals
    Cout = payload.shape[-1]
    payload = torch.gather(payload, 1, order[..., None].expand(B, N, Cout))
    # Losers and culled points all land in one extra row that is cut off.
    dest = torch.where(first, pix_s, hw).to(torch.int64)
    out = torch.zeros(B, hw + 1, Cout, dtype=torch.float32, device=pix.device)
    out.scatter_(1, dest[..., None].expand(B, N, Cout), payload)
    return out[:, :hw].reshape(B, height, width, Cout)


def placement(pix, r, vals, height: int, width: int, packed: bool = False,
              append_range: bool = True) -> torch.Tensor:
    """Dense winner placement ``-> [B, H, W, C + append_range]`` float32,
    under the exact or (``packed``) the packed winner rule.

    On CUDA tensors it launches the kernel (and counts the call in
    ``placement.launches_exact`` or ``placement.launches_packed``, by rule);
    on CPU tensors it runs :func:`placement_plain`.
    Ranges of in-range points must be finite and not -0.0 (exact rule) or
    > 0 (packed rule); projection gives ranges > 0.
    """
    dev = pix.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return placement_plain(pix, r, vals, height, width, packed, append_range)
        raise ValueError(f"placement runs on cuda or cpu, not {dev}")
    _check_launch(pix, r, vals, height, width)
    B, N = pix.shape
    C = vals.shape[2]
    hw = height * width
    index = dev.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    keys = _workspace(index, stream, B * hw, dev)
    out = vals.new_empty((B, height, width, C + int(append_range)))
    err = _launcher()(pix.data_ptr(), r.data_ptr(), vals.data_ptr(), keys.data_ptr(),
                      out.data_ptr(), B, N, C, hw, int(packed), int(key_bits(packed, N) == 32),
                      int(append_range), index, stream)
    if err != 0:
        _workspaces.pop((index, stream), None)
        raise RuntimeError(f"placement kernel launch failed with CUDA error {err}")
    if packed:
        placement.launches_packed += 1
    else:
        placement.launches_exact += 1
    return out


placement.launches_exact = 0
placement.launches_packed = 0

# Winner keys, one buffer per (device index, raw stream), all bytes 0xFF (the
# empty key at either width) between calls: the kernel's write pass resets
# every key it reads, so no call fills it. Calls on one stream run in order,
# so they can share it. A larger call replaces its stream's buffer here and
# drops the old one, which a captured CUDA graph may still read: a graph
# keeps what :func:`workspaces` held at its capture.
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(index: int, stream: int, pixels: int, device) -> torch.Tensor:
    """At least ``pixels`` 64-bit empty keys for this device and stream."""
    keys = _workspaces.get((index, stream))
    if keys is None or keys.numel() < pixels:
        keys = torch.full((pixels,), -1, dtype=torch.int64, device=device)
        _workspaces[(index, stream)] = keys
    return keys


def workspaces() -> Tuple[torch.Tensor, ...]:
    """Every winner-key buffer in use now. A CUDA graph that captured a call
    holds these for as long as it may replay (``training/graphed.py``), so a
    buffer replaced by a larger call is not freed under it."""
    return tuple(_workspaces.values())


@functools.lru_cache(maxsize=None)
def _launcher():
    """``placement_launch`` of the built library, its argument types set once."""
    fn = load_library("placement").placement_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
