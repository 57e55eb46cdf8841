"""Image-space window matcher: the kernel's wrappers and their plain versions.

For each pixel of a query xyz image, the occupied candidate pixels in a
``wv x wu`` window around it: rows beyond the image are empty (not clamped),
the azimuth wraps, offsets run dv-major and du-minor, and an unoccupied
candidate is +inf. Three searches share that window:

- :func:`window_match` (hard): the nearest candidate, strict ``<`` (ties go to
  the first offset); its squared distance (+inf if none), xyz and normal
  (zeros if none). The loop of
  ``delora_tpu/ops/correspondence.py::image_space_correspondence_core``
  (hard branch, :270-292).
- :func:`window_match_indices`: the same argmin, returning the winner's offset
  index ``k = dv * wu + du_idx`` (0 if none) and its squared distance, with
  the candidates' occupancy read from a separate plane (> 0.5). The loop of
  ``window_match_indices`` (:495-555), the reverse direction's search.
- :func:`window_match_soft`: every occupied candidate weighs
  ``w = exp(-sq / sigma^2)``, unnormalised; the blend ``sum(w x) / max(sum w,
  1e-30)`` of xyz and of normals (not renormalised), and the window's
  minimum squared distance, +inf where ``sum w < 1e-30``. The soft branch of
  the core (:228-268). Every weight, product, sum and quotient of the blend
  is flushed to zero where it is subnormal, as the reference's arithmetic is
  (XLA on the CPU and the TPU flush subnormals; ``exp`` of less than about
  -87.3 is 0 there): a weight that underflows past the smallest normal float
  must not leave a tiny non-zero blended normal, which would count as "has a
  normal" in the losses.

A target candidate is occupied where its xyz is not all zero. The CUDA kernels
are ``delora_tpu_torch/csrc/window_match.cu``; they replace the TPU kernels
``delora_tpu/ops/pallas/window_match.py::window_match_pallas`` (hard and
soft branches) and ``_window_match_tiled``.

Inputs are ``[B, H, W, 3]`` float32 channels-last tensors; each may be a
channel slice of a wider channels-last tensor (for example the xyz of a
``[B, H, W, 7]`` image), read in place, and so may the ``[B, H, W]``
occupancy plane. Nothing here carries gradients: the searches are detached,
as in the reference.

A call on CUDA tensors is kept lean on the host, as the placement's: the
``ctypes`` functions are configured once, the checks are attribute tests and
the stream is read as a raw pointer; a call allocates only its outputs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from delora_tpu_torch.ops.cuda.build import load_library
from delora_tpu_torch.ops.exact import squared_distance

# The hard kernel's block: _TILE_H rows of _TILE_W query pixels, two rows a
# thread, whose windows' candidates it stages in shared memory (kTileH,
# kTileW in csrc/window_match.cu); a block may take at most
# _SMEM_LIMIT bytes on the H100, which bounds the window the kernel takes.
_TILE_H, _TILE_W = 8, 64
_SMEM_LIMIT = 232448
_MAX_HEIGHT = _TILE_H * 65535       # the grid's rows of tiles
_INT32_LIMIT = 2**31


def _strides(t: torch.Tensor, name: str) -> Tuple[int, int]:
    """(batch, pixel) strides in floats of a ``[B, H, W, 3]`` view whose
    channels are contiguous, or of a ``[B, H, W]`` plane, whose pixels are
    evenly spaced."""
    if (t.dim() == 4 and t.stride(3) != 1) or t.stride(1) != t.shape[2] * t.stride(2):
        raise ValueError(f"{name} must be channels-last with evenly spaced pixels, "
                         f"got strides {t.stride()}")
    return t.stride(0), t.stride(2)


def _check(window, src, **others):
    for name, t in (("src", src), *others.items()):
        shape = src.shape if t.dim() == 4 else src.shape[:3]
        if t.dim() not in (3, 4) or (t.dim() == 4 and t.shape[-1] != 3):
            raise ValueError(f"{name} must be [B, H, W, 3] (or [B, H, W] for an occupancy "
                             f"plane), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit src {tuple(src.shape)}")
        if t.device != src.device:
            raise ValueError("the matcher's inputs must lie on one device")
    if src.dim() != 4:
        raise ValueError(f"src must be [B, H, W, 3], got {tuple(src.shape)}")
    wv, wu = window
    if wv < 1 or wu < 1 or wv % 2 == 0 or wu % 2 == 0:
        raise ValueError(f"window must be two odd sizes >= 1, got {window}")
    if src.numel() >= 2**31:
        raise ValueError("sizes must fit in int32")


def smem_bytes(window) -> int:
    """Shared memory of one block of the hard kernel for ``window``: its
    candidate halo, 16 B a cell."""
    wv, wu = window
    return (_TILE_H + wv - 1) * (_TILE_W + wu - 1) * 16


def _fits(t: torch.Tensor, shape, dev) -> bool:
    """A float32 ``[B, H, W, 3]`` view with contiguous channels, or a
    ``[B, H, W]`` plane, of ``shape`` on ``dev``, its pixels evenly spaced."""
    st = t.stride()
    return (t.dtype is torch.float32 and t.shape == shape and t.device == dev
            and st[1] == shape[2] * st[2] and (len(shape) == 3 or st[3] == 1))


def _check_launch(window, src, xyz, third, third_name: str, hard: bool = True):
    """What a kernel needs, as one chain of attribute tests: ``src`` and the
    candidates' ``xyz`` ``[B, H, W, 3]``, ``third`` the normals (same shape)
    or, named ``cand_occ``, the occupancy plane ``[B, H, W]``; float32 on one
    device, channels contiguous, pixels evenly spaced; an odd window; sizes
    within int32; for the hard kernel, a halo that fits a block's shared
    memory and at most _MAX_HEIGHT rows. On a failure the long checks name
    the fault."""
    ss, dev = src.shape, src.device
    wv, wu = window
    third_shape = ss[:3] if third_name == "cand_occ" else ss
    if not (len(ss) == 4 and ss[3] == 3 and _fits(src, ss, dev) and _fits(xyz, ss, dev)
            and _fits(third, third_shape, dev) and wv % 2 == 1 and wu % 2 == 1 and wv > 0
            and wu > 0 and src.numel() < _INT32_LIMIT
            and (not hard or (ss[1] <= _MAX_HEIGHT and smem_bytes(window) <= _SMEM_LIMIT))):
        _check(window, src, **{"candidate xyz": xyz, third_name: third})
        for name, t in (("src", src), ("candidate xyz", xyz), (third_name, third)):
            _strides(t, name)
        if hard and ss[1] > _MAX_HEIGHT:
            raise ValueError(f"the kernel takes images of at most {_MAX_HEIGHT} rows")
        if hard and smem_bytes(window) > _SMEM_LIMIT:
            raise ValueError(f"window {tuple(window)} is too large for the kernel: its halo "
                             f"needs {smem_bytes(window)} bytes of shared memory, a block may "
                             f"take {_SMEM_LIMIT}")
        raise ValueError(f"{third_name} must be {tuple(third_shape)}, got {tuple(third.shape)}")


def _device(src: torch.Tensor, name: str) -> bool:
    """True where the kernel runs (CUDA), False for the plain version (CPU)."""
    if src.device.type == "cpu":
        return False
    if src.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {src.device}")
    return True


_TINY = float(np.finfo(np.float32).tiny)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """x with its subnormal values replaced by +0."""
    return torch.where(x.abs() < _TINY, 0.0, x)


def inv_tau(sigma: float) -> float:
    """1 / sigma^2 rounded to float32, as the reference's f32 loop uses it."""
    return float(np.float32(1.0 / float(sigma) ** 2))


def _window(pad: torch.Tensor, window, height: int):
    """Yield (k, candidate image) over the window's offsets, dv-major: the
    row-padded ``pad`` shifted so that ``cand[h, w] = pad[h + dv, w + du]``."""
    wv, wu = window
    bu = wu // 2
    for dv in range(wv):
        slab = pad[:, dv:dv + height]
        for kk in range(wu):
            yield dv * wu + kk, torch.roll(slab, bu - kk, dims=2)


def _pad_rows(t: torch.Tensor, window) -> torch.Tensor:
    a = window[0] // 2
    return F.pad(t, (0, 0, 0, 0, a, a))                          # empty rows


def _target_occupancy(tgt_xyz: torch.Tensor) -> torch.Tensor:
    return (tgt_xyz != 0.0).any(-1).to(torch.float32)


def window_match_indices_plain(src, cand_xyz, cand_occ, window):
    """Plain version of :func:`window_match_indices`: the reference's loop over
    the ``wv * wu`` shifted candidate images."""
    _check(window, src, cand_xyz=cand_xyz, cand_occ=cand_occ)
    B, H, W, _ = src.shape
    pad = _pad_rows(torch.cat([cand_xyz, cand_occ[..., None]], dim=-1), window)
    best_sq = torch.full((B, H, W), float("inf"), device=src.device)
    best_k = torch.zeros((B, H, W), dtype=torch.int32, device=src.device)
    for k, cand in _window(pad, window, H):
        sq = squared_distance(cand[..., 0:3] - src)
        sq = torch.where(cand[..., 3] > 0.5, sq, float("inf"))
        better = sq < best_sq
        best_sq = torch.where(better, sq, best_sq)
        best_k = torch.where(better, k, best_k)
    return best_k, best_sq


def winner_pixel(best_k: torch.Tensor, window, height: int, width: int) -> torch.Tensor:
    """The flat candidate pixel of each offset index ``[B, H, W]`` ->
    ``[B, H * W]`` int64: row ``clip(h + k // wu - wv // 2, 0, H - 1)``,
    column ``(w + k % wu - wu // 2) mod W`` (the reference's reconstruction,
    training/step.py:341-346; rows of real winners are in range)."""
    wv, wu = window
    B = best_k.shape[0]
    k = best_k.reshape(B, height * width).to(torch.int64)
    p = torch.arange(height * width, device=best_k.device)
    row = torch.clamp(p // width + k // wu - wv // 2, 0, height - 1)
    col = torch.remainder(p % width + k % wu - wu // 2, width)
    return row * width + col


def _gather_pixels(img: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    B, H, W, C = img.shape
    return torch.gather(img.reshape(B, H * W, C), 1, pix[..., None].expand(-1, -1, C))


def window_match_plain(src, tgt_xyz, tgt_nrm, window):
    """Plain version of :func:`window_match`: the offset search of
    :func:`window_match_indices_plain` with the target's occupancy, then the
    winners' xyz and normal."""
    _check(window, src, tgt_xyz=tgt_xyz, tgt_nrm=tgt_nrm)
    B, H, W, _ = src.shape
    best_k, best_sq = window_match_indices_plain(src, tgt_xyz, _target_occupancy(tgt_xyz),
                                                 window)
    pix = winner_pixel(best_k, window, H, W)
    found = torch.isfinite(best_sq).reshape(B, H * W, 1)
    best_xyz = torch.where(found, _gather_pixels(tgt_xyz, pix), 0.0)
    best_nrm = torch.where(found, _gather_pixels(tgt_nrm, pix), 0.0)
    return best_sq, best_xyz.reshape(B, H, W, 3), best_nrm.reshape(B, H, W, 3)


def window_match_soft_plain(src, tgt_xyz, tgt_nrm, window, sigma: float):
    """Plain version of :func:`window_match_soft`: the reference's soft loop
    in the same operation order (a separate multiply and add for each
    accumulation), subnormals flushed."""
    _check(window, src, tgt_xyz=tgt_xyz, tgt_nrm=tgt_nrm)
    B, H, W, _ = src.shape
    tau = inv_tau(sigma)
    pad = _pad_rows(torch.cat([tgt_xyz, tgt_nrm, _target_occupancy(tgt_xyz)[..., None]],
                              dim=-1), window)
    best_sq = torch.full((B, H, W), float("inf"), device=src.device)
    acc_w = torch.zeros((B, H, W), device=src.device)
    acc_xyz = torch.zeros((B, H, W, 3), device=src.device)
    acc_nrm = torch.zeros((B, H, W, 3), device=src.device)
    for _, cand in _window(pad, window, H):
        sq = squared_distance(cand[..., 0:3] - src)
        sq = torch.where(cand[..., 6] > 0.5, sq, float("inf"))
        w = flush_subnormal(torch.where(torch.isfinite(sq), torch.exp(-sq * tau), 0.0))
        best_sq = torch.minimum(best_sq, sq)
        acc_w = flush_subnormal(acc_w + w)
        acc_xyz = flush_subnormal(acc_xyz + flush_subnormal(w[..., None] * cand[..., 0:3]))
        acc_nrm = flush_subnormal(acc_nrm + flush_subnormal(w[..., None] * cand[..., 3:6]))
    best_sq = torch.where(acc_w < 1e-30, float("inf"), best_sq)
    denom = torch.clamp(acc_w, min=1e-30)[..., None]
    return best_sq, flush_subnormal(acc_xyz / denom), flush_subnormal(acc_nrm / denom)


def window_match(src, tgt_xyz, tgt_nrm, window):
    """Hard window match ``-> (best_sq, best_xyz, best_nrm)``.

    On CUDA tensors it launches the kernel (and counts the launch in
    ``window_match.launches``); on CPU tensors it runs
    :func:`window_match_plain`.
    """
    if not _device(src, "window_match"):
        return window_match_plain(src, tgt_xyz, tgt_nrm, window)
    _check_launch(window, src, tgt_xyz, tgt_nrm, "tgt_nrm")
    shape = src.shape
    best_sq = src.new_empty(shape[:3])
    best_xyz = src.new_empty(shape)
    best_nrm = src.new_empty(shape)
    _launch_hard(src, tgt_xyz, tgt_nrm, None, best_sq, best_xyz, best_nrm, None, window)
    window_match.launches += 1
    return best_sq, best_xyz, best_nrm


def window_match_indices(src, cand_xyz, cand_occ, window):
    """Hard window match returning the winner's offset ``-> (best_k int32,
    best_sq)``, both ``[B, H, W]``; ``cand_occ`` ``[B, H, W]`` float32 marks
    occupied candidates (> 0.5).

    On CUDA tensors it launches the kernel (and counts the launch in
    ``window_match_indices.launches``); on CPU tensors it runs
    :func:`window_match_indices_plain`.
    """
    if not _device(src, "window_match_indices"):
        return window_match_indices_plain(src, cand_xyz, cand_occ, window)
    _check_launch(window, src, cand_xyz, cand_occ, "cand_occ")
    best_sq = src.new_empty(src.shape[:3])
    best_k = torch.empty(src.shape[:3], dtype=torch.int32, device=src.device)
    _launch_hard(src, cand_xyz, None, cand_occ, best_sq, None, None, best_k, window)
    window_match_indices.launches += 1
    return best_k, best_sq


def window_match_soft(src, tgt_xyz, tgt_nrm, window, sigma: float):
    """Soft window match ``-> (best_sq, blended xyz, blended normal)`` with
    weights ``exp(-sq / sigma^2)``.

    On CUDA tensors it launches the kernel (and counts the launch in
    ``window_match_soft.launches``); on CPU tensors it runs
    :func:`window_match_soft_plain`.
    """
    if not (sigma > 0.0):
        raise ValueError(f"the soft matcher needs sigma > 0, got {sigma}")
    if not _device(src, "window_match_soft"):
        return window_match_soft_plain(src, tgt_xyz, tgt_nrm, window, sigma)
    _check_launch(window, src, tgt_xyz, tgt_nrm, "tgt_nrm", hard=False)
    shape = src.shape
    best_sq = src.new_empty(shape[:3])
    best_xyz = src.new_empty(shape)
    best_nrm = src.new_empty(shape)
    index = src.device.index
    err = _launchers()[1](
        *_view(src), *_view(tgt_xyz), *_view(tgt_nrm), best_sq.data_ptr(), best_xyz.data_ptr(),
        best_nrm.data_ptr(), shape[0], shape[1], shape[2], window[0], window[1], inv_tau(sigma),
        index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"window_match_soft kernel launch failed with CUDA error {err}")
    window_match_soft.launches += 1
    return best_sq, best_xyz, best_nrm


window_match.launches = 0
window_match_indices.launches = 0
window_match_soft.launches = 0


def _view(t):
    """(pointer, batch stride, pixel stride) of a kernel input; null if None."""
    return (0, 0, 0) if t is None else (t.data_ptr(), t.stride(0), t.stride(2))


def _launch_hard(src, txyz, tnrm, occ, out_sq, out_xyz, out_nrm, out_k, window):
    """One launch of the hard kernel; ``None`` inputs and outputs are null."""
    def ptr(t):
        return 0 if t is None else t.data_ptr()

    B, H, W, _ = src.shape
    index = src.device.index
    err = _launchers()[0](
        *_view(src), *_view(txyz), *_view(tnrm), *_view(occ), ptr(out_sq), ptr(out_xyz),
        ptr(out_nrm), ptr(out_k), B, H, W, window[0], window[1], index,
        torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"window_match kernel launch failed with CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _launchers():
    """(``window_match_launch``, ``window_match_soft_launch``) of the built
    library, their argument types set once."""
    lib = load_library("window_match")
    view = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    hard = lib.window_match_launch
    hard.argtypes = view * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    hard.restype = ctypes.c_int
    soft = lib.window_match_soft_launch
    soft.argtypes = (view * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    soft.restype = ctypes.c_int
    return hard, soft
