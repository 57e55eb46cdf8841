"""Hard image-space window matcher: the kernel's wrapper and its plain version.

For each pixel of a warped-source xyz image, the nearest occupied target pixel
in a ``wv x wu`` window around it: rows beyond the image are empty (not
clamped), the azimuth wraps, offsets run dv-major and du-minor with strict
``<`` (ties go to the first offset), and an unoccupied target pixel (xyz all
zero) is +inf. Returns the winner's squared distance (+inf if none), target
xyz and target normal (zeros if none). The plain version is the loop of
``delora_tpu/ops/correspondence.py::image_space_correspondence_core``
(hard branch, :270-292). The CUDA kernel is
``delora_tpu_torch/csrc/window_match.cu``; it replaces the TPU kernels
``delora_tpu/ops/pallas/window_match.py::window_match_pallas`` (hard branch)
and ``_window_match_tiled``.

Inputs are ``[B, H, W, 3]`` float32 channels-last tensors; each may be a
channel slice of a wider channels-last tensor (for example the xyz of a
``[B, H, W, 7]`` image), read in place. Nothing here carries gradients: the
search is detached, as in the reference.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from delora_tpu_torch.ops.cuda.build import load_library


def _strides(t: torch.Tensor, name: str) -> Tuple[int, int]:
    """(batch, pixel) strides in floats of a ``[B, H, W, 3]`` view whose
    channels are contiguous and whose pixels are evenly spaced."""
    if t.stride(3) != 1 or t.stride(1) != t.shape[2] * t.stride(2):
        raise ValueError(f"{name} must be channels-last with evenly spaced pixels, "
                         f"got strides {t.stride()}")
    return t.stride(0), t.stride(2)


def _check(src, tgt_xyz, tgt_nrm, window):
    for name, t in (("src", src), ("tgt_xyz", tgt_xyz), ("tgt_nrm", tgt_nrm)):
        if t.dim() != 4 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be [B, H, W, 3], got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.shape != src.shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from src {tuple(src.shape)}")
        if t.device != src.device:
            raise ValueError("src, tgt_xyz and tgt_nrm must lie on one device")
    wv, wu = window
    if wv < 1 or wu < 1 or wv % 2 == 0 or wu % 2 == 0:
        raise ValueError(f"window must be two odd sizes >= 1, got {window}")
    if src.numel() >= 2**31:
        raise ValueError("sizes must fit in int32")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors: a * b is exact in float64, so one
    float64 sum rounded to float32 is the fused result (but for
    double-rounding cases, about one in 2**29; the kernel computes the same
    float64 steps, so it agrees with this bit for bit)."""
    return (a.double() * b.double() + c.double()).float()


def squared_distance(d: torch.Tensor) -> torch.Tensor:
    """|d|^2 over the last axis as the reference's compiled matcher forms it:
    fma(dz, dz, fma(dy, dy, dx * dx))."""
    x, y, z = d.unbind(-1)
    return _fma(z, z, _fma(y, y, x * x))


def window_match_plain(src, tgt_xyz, tgt_nrm, window):
    """Plain PyTorch version: the reference's loop over the ``wv * wu``
    shifted target images. -> (best_sq [B, H, W], best_xyz [B, H, W, 3],
    best_nrm [B, H, W, 3])."""
    _check(src, tgt_xyz, tgt_nrm, window)
    wv, wu = window
    a, bu = wv // 2, wu // 2
    B, H, W, _ = src.shape
    occ = (tgt_xyz != 0.0).any(-1, keepdim=True).to(torch.float32)
    tgt = torch.cat([tgt_xyz, tgt_nrm, occ], dim=-1)
    tgt_pad = F.pad(tgt, (0, 0, 0, 0, a, a))                   # empty rows
    best_sq = torch.full((B, H, W), float("inf"), device=src.device)
    best_xyz = torch.zeros_like(src, memory_format=torch.contiguous_format)
    best_nrm = torch.zeros_like(best_xyz)
    for dv in range(wv):
        slab = tgt_pad[:, dv:dv + H]
        for du in range(-bu, bu + 1):
            cand = torch.roll(slab, -du, dims=2)              # cand[w] = slab[w + du]
            sq = squared_distance(cand[..., 0:3] - src)
            sq = torch.where(cand[..., 6] > 0.5, sq, float("inf"))
            better = sq < best_sq
            best_sq = torch.where(better, sq, best_sq)
            best_xyz = torch.where(better[..., None], cand[..., 0:3], best_xyz)
            best_nrm = torch.where(better[..., None], cand[..., 3:6], best_nrm)
    return best_sq, best_xyz, best_nrm


def window_match(src, tgt_xyz, tgt_nrm, window):
    """Hard window match ``-> (best_sq, best_xyz, best_nrm)``.

    On CUDA tensors it launches the kernel (and counts the launch in
    ``window_match.launches``); on CPU tensors it runs
    :func:`window_match_plain`.
    """
    if src.device.type == "cpu":
        return window_match_plain(src, tgt_xyz, tgt_nrm, window)
    if src.device.type != "cuda":
        raise ValueError(f"window_match runs on cuda or cpu, not {src.device}")
    _check(src, tgt_xyz, tgt_nrm, window)
    strides = [s for name, t in (("src", src), ("tgt_xyz", tgt_xyz), ("tgt_nrm", tgt_nrm))
               for s in _strides(t, name)]
    B, H, W, _ = src.shape
    wv, wu = window
    best_sq = torch.empty(B, H, W, dtype=torch.float32, device=src.device)
    best_xyz = torch.empty(B, H, W, 3, dtype=torch.float32, device=src.device)
    best_nrm = torch.empty_like(best_xyz)
    lib = _library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.window_match_launch(
            src.data_ptr(), strides[0], strides[1], tgt_xyz.data_ptr(), strides[2],
            strides[3], tgt_nrm.data_ptr(), strides[4], strides[5], best_sq.data_ptr(),
            best_xyz.data_ptr(), best_nrm.data_ptr(), B, H, W, wv, wu, stream,
        )
    if err != 0:
        raise RuntimeError(f"window_match kernel launch failed with CUDA error {err}")
    window_match.launches += 1
    return best_sq, best_xyz, best_nrm


window_match.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("window_match")
    fn = lib.window_match_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
