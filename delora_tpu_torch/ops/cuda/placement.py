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
kernel ``delora_tpu/ops/pallas/placement.py::placement_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from delora_tpu_torch.ops.cuda.build import load_library


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
    if max(pix.shape[0], pix.shape[1], vals.shape[2] + 1, height * width) >= 2**31:
        raise ValueError("sizes must fit in int32")


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

    On CUDA tensors it launches the kernel (and counts the launch in
    ``placement.launches``); on CPU tensors it runs :func:`placement_plain`.
    Ranges of in-range points must be finite and not -0.0 (exact rule) or
    > 0 (packed rule); projection gives ranges > 0.
    """
    if pix.device.type == "cpu":
        return placement_plain(pix, r, vals, height, width, packed, append_range)
    if pix.device.type != "cuda":
        raise ValueError(f"placement runs on cuda or cpu, not {pix.device}")
    _check(pix, r, vals, height, width)
    if not (pix.is_contiguous() and r.is_contiguous() and vals.is_contiguous()):
        raise ValueError("placement kernel needs contiguous inputs")
    lib = _library()
    B, N = pix.shape
    C = vals.shape[-1]
    hw = height * width
    keys = torch.empty(B * hw, dtype=torch.int64, device=pix.device)
    out = torch.empty(B, height, width, C + int(append_range), dtype=torch.float32,
                      device=pix.device)
    with torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.placement_launch(
            pix.data_ptr(), r.data_ptr(), vals.data_ptr(), keys.data_ptr(),
            out.data_ptr(), B, N, C, hw, int(packed), int(append_range), stream,
        )
    if err != 0:
        raise RuntimeError(f"placement kernel launch failed with CUDA error {err}")
    placement.launches += 1
    return out


placement.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("placement")
    fn = lib.placement_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
