"""The placement wrapper's host side, on the CPU: the key width it picks,
its launch checks, its key workspace and its CPU dispatch.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``); here
each test reaches the wrapper's Python with CPU tensors. Results are compared
bit for bit.
"""

import numpy as np
import pytest
import torch

from delora_tpu_torch.ops.cuda import placement as mod
from delora_tpu_torch.ops.cuda.placement import (
    PACKED32_MAX_N,
    _check_launch,
    key_bits,
    placement,
    placement_plain,
)


@pytest.mark.parametrize("packed,n,bits", [
    (True, 1, 32), (True, PACKED32_MAX_N, 32), (True, PACKED32_MAX_N + 1, 64),
    (True, 131072, 64), (False, 1, 64), (False, PACKED32_MAX_N, 64),
])
def test_key_width_is_32_bits_only_for_packed_with_16_bit_indices(packed, n, bits):
    assert PACKED32_MAX_N == 65536
    assert key_bits(packed, n) == bits


def good_inputs(b=2, n=8, c=3):
    return (torch.zeros(b, n, dtype=torch.int32), torch.ones(b, n), torch.ones(b, n, c))


def test_check_launch_accepts_what_the_kernel_takes():
    _check_launch(*good_inputs(), 2, 4)
    _check_launch(*good_inputs(c=0), 2, 4)


@pytest.mark.parametrize("case", [
    "pix-int64", "r-float64", "vals-float64", "r-shorter", "vals-rank-2", "vals-other-rows",
    "pix-rank-3", "other-device", "pix-strided", "r-strided", "vals-transposed", "height-0",
    "width-negative", "pixels-past-int32",
])
def test_check_launch_rejects_bad_inputs(case):
    """Each input the kernel cannot take raises ValueError before a launch:
    those of ``test_placement_rejects_bad_inputs`` and non-contiguous ones."""
    pix, r, vals = good_inputs()
    height, width = 2, 4
    if case == "pix-int64":
        pix = pix.long()
    elif case == "r-float64":
        r = r.double()
    elif case == "vals-float64":
        vals = vals.double()
    elif case == "r-shorter":
        r = r[:, :4]
    elif case == "vals-rank-2":
        vals = vals[0]
    elif case == "vals-other-rows":
        vals = vals[:, :4]
    elif case == "pix-rank-3":
        pix = pix[..., None]
    elif case == "other-device":
        r = r.to("meta")
    elif case == "pix-strided":
        pix = torch.zeros(2, 16, dtype=torch.int32)[:, ::2]
    elif case == "r-strided":
        r = torch.ones(8, 2).t()
    elif case == "vals-transposed":
        vals = torch.ones(2, 3, 8).transpose(1, 2)
    elif case == "height-0":
        height = 0
    elif case == "width-negative":
        width = -4
    elif case == "pixels-past-int32":
        height, width = 1 << 16, 1 << 15
    with pytest.raises(ValueError):
        _check_launch(pix, r, vals, height, width)


def test_cpu_tensors_dispatch_to_the_plain_version(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args)
        return placement_plain(*args)

    monkeypatch.setattr(mod, "placement_plain", spy)
    monkeypatch.setattr(mod, "_launcher", lambda: pytest.fail("CPU call reached the kernel"))
    pix = torch.tensor([[1, 1, 0, 9]], dtype=torch.int32)
    r = torch.tensor([[2.0, 1.0, 3.0, 1.0]])
    vals = torch.arange(4, dtype=torch.float32).reshape(1, 4, 1)
    before = placement.launches
    out = placement(pix, r, vals, 2, 2, packed=True, append_range=False)
    assert len(calls) == 1 and calls[0][5:] == (True, False)
    assert placement.launches == before
    np.testing.assert_array_equal(out.reshape(-1).numpy(), [2.0, 1.0, 0.0, 0.0])


def test_workspace_is_kept_per_stream_and_grows_filled_with_empty_keys(monkeypatch):
    """One buffer per (device, stream), every bit set; a call that needs no
    more reuses it, a larger call replaces it with a larger filled one."""
    monkeypatch.setattr(mod, "_workspaces", {})
    cpu = torch.device("cpu")
    first = mod._workspace(0, 11, 100, cpu)
    assert first.dtype == torch.int64 and first.numel() == 100
    assert bool((first == -1).all())
    assert mod._workspace(0, 11, 60, cpu) is first
    other = mod._workspace(0, 12, 60, cpu)
    assert other is not first and other.numel() == 60
    grown = mod._workspace(0, 11, 150, cpu)
    assert grown.numel() == 150 and bool((grown == -1).all())
    assert mod._workspaces == {(0, 11): grown, (0, 12): other}
