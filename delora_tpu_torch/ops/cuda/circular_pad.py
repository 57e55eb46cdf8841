"""Circular width pad of the backbone's activations: the kernel's wrapper and
its plain version.

``circular_pad(x, pad_w, pad_h, value)`` wraps azimuth (the last dimension
of ``[B, C, H, W]``) by ``pad_w`` columns on each side and pads the rings
(H) with ``pad_h`` rows of ``value`` (``delora_tpu/models/resnet.py::
pad_circular_w``, there in NHWC). On CPU tensors it is the plain version, a
``torch.cat`` and an ``F.pad`` differentiated by autograd, which keep the
input's layout. On CUDA tensors it is a ``torch.autograd.Function`` over
``delora_tpu_torch/csrc/circular_pad.cu``: one launch forward and one
backward on a channels-last float32 or bfloat16 tensor, which it returns
channels-last (the backbone runs channels-last on the card,
``models/odometry.py``). A CUDA input in another layout is laid out
channels-last first. A thread moves 16 bytes where a pixel's channels and
both pointers allow it (every layer of the model at its published widths),
one element otherwise. Each launch counts
in ``circular_pad.launches_forward`` or ``circular_pad.launches_backward``.

The host side is kept lean, as the placement wrapper's: the ``ctypes``
functions are configured once, the fill's bytes are cached by value and
type, and the stream is read as a raw pointer.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from delora_tpu_torch.ops.cuda.build import load_library

# The kernel's element types, the model's (the backward adds in them).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_LIMIT = 1 << 31


def circular_pad_plain(x: torch.Tensor, pad_w: int = 1, pad_h: int = 1,
                       value: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version: ``[B, C, H, W] -> [B, C, H + 2 pad_h,
    W + 2 pad_w]`` in the input's layout (NCHW or channels-last)."""
    if pad_w:
        x = torch.cat([x[..., -pad_w:], x, x[..., :pad_w]], dim=-1)
    if pad_h:
        x = F.pad(x, (0, 0, pad_h, pad_h), value=value)
    return x


def circular_pad(x: torch.Tensor, pad_w: int = 1, pad_h: int = 1,
                 value: float = 0.0) -> torch.Tensor:
    """Wrap-pad azimuth (W) by ``pad_w``, constant-pad rings (H) by ``pad_h``
    rows of ``value``: the kernel on CUDA tensors (channels-last out), the
    plain version on CPU tensors."""
    dev = x.device.type
    if dev == "cuda":
        return _CircularPad.apply(x, pad_w, pad_h, value)
    if dev == "cpu":
        return circular_pad_plain(x, pad_w, pad_h, value)
    raise ValueError(f"circular_pad runs on cuda or cpu, not {x.device}")


circular_pad.launches_forward = 0
circular_pad.launches_backward = 0


class _CircularPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pad_w, pad_h, value):
        ctx.pads = (pad_w, pad_h)
        return _pad_forward(x, pad_w, pad_h, value)

    @staticmethod
    def backward(ctx, grad):
        return _pad_backward(grad, *ctx.pads), None, None, None


def _shape_check(x: torch.Tensor, pad_w: int, pad_h: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"circular_pad needs [B, C, H, W], got {tuple(x.shape)}")
    if not 0 <= pad_w <= x.shape[3] or pad_h < 0:
        raise ValueError(f"pads ({pad_w}, {pad_h}) do not fit width {x.shape[3]}")
    B, C, H, W = x.shape
    if max(B * (H + 2 * pad_h), (W + 2 * pad_w) * C * x.element_size()) >= _INT32_LIMIT:
        raise ValueError("sizes must fit in int32")


def _dtype_code(x: torch.Tensor) -> int:
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"circular_pad's kernel takes {sorted(map(str, _DTYPE_CODES))}, "
                         f"not {x.dtype}")
    return code


def _vec_bytes(pixel_bytes: int, element_bytes: int, *ptrs: int) -> int:
    """16 where it divides a pixel and each pointer, else one element."""
    return 16 if not pixel_bytes % 16 and not any(p % 16 for p in ptrs) else element_bytes


def _pad_forward(x: torch.Tensor, pad_w: int, pad_h: int, value: float) -> torch.Tensor:
    _shape_check(x, pad_w, pad_h)
    _dtype_code(x)
    x = x.contiguous(memory_format=torch.channels_last)
    B, C, H, W = x.shape
    out = torch.empty((B, C, H + 2 * pad_h, W + 2 * pad_w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    pixel = C * x.element_size()
    index = x.device.index
    err = _launchers()[0](x.data_ptr(), out.data_ptr(), B, H, W, pixel, pad_w, pad_h,
                          _vec_bytes(pixel, x.element_size(), x.data_ptr(), out.data_ptr()),
                          _fill(float(value), x.dtype), index,
                          torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"circular_pad forward launch failed with CUDA error {err}")
    circular_pad.launches_forward += 1
    return out


def _pad_backward(grad: torch.Tensor, pad_w: int, pad_h: int) -> torch.Tensor:
    grad = grad.contiguous(memory_format=torch.channels_last)
    B, C, Hp, Wp = grad.shape
    H, W = Hp - 2 * pad_h, Wp - 2 * pad_w
    code = _dtype_code(grad)
    out = torch.empty((B, C, H, W), dtype=grad.dtype, device=grad.device,
                      memory_format=torch.channels_last)
    pixel = C * grad.element_size()
    index = grad.device.index
    err = _launchers()[1](grad.data_ptr(), out.data_ptr(), B, H, W, pixel, pad_w, pad_h, code,
                          _vec_bytes(pixel, grad.element_size(), grad.data_ptr(),
                                     out.data_ptr()), index,
                          torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"circular_pad backward launch failed with CUDA error {err}")
    circular_pad.launches_backward += 1
    return out


@functools.lru_cache(maxsize=None)
def _fill(value: float, dtype: torch.dtype) -> ctypes.Array:
    """16 bytes: ``value`` in ``dtype``, repeated."""
    one = torch.tensor([value], dtype=dtype).view(torch.uint8)
    return (ctypes.c_ubyte * 16)(*one.repeat(16 // one.numel()).tolist())


@functools.lru_cache(maxsize=None)
def _launchers():
    """``circular_pad_forward`` and ``_backward`` of the built library, their
    argument types set once."""
    lib = load_library("circular_pad")
    forward, backward = lib.circular_pad_forward, lib.circular_pad_backward
    forward.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p,
                                                                      ctypes.c_int,
                                                                      ctypes.c_void_p]
    backward.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    forward.restype = backward.restype = ctypes.c_int
    return forward, backward
