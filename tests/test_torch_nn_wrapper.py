"""The 1-NN wrapper's host side, on the CPU: its launch checks, its scratch
size, its workspace cache and its CPU dispatch.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``); here
each test reaches the wrapper's Python with CPU tensors. Results are compared
bit for bit.
"""

import numpy as np
import pytest
import torch

from delora_tpu_torch.ops.cuda import nn_search as mod
from delora_tpu_torch.ops.cuda.nn_search import (
    _check_launch,
    nn_search,
    nn_search_plain,
    scratch_bytes,
)


def good_inputs(b=2, s=5, t=8):
    return torch.zeros(b, s, 3), torch.ones(b, t, 3), torch.ones(b, t, dtype=torch.bool)


def test_check_launch_accepts_what_the_kernel_takes():
    _check_launch(*good_inputs())
    _check_launch(*good_inputs(s=0))
    _check_launch(*good_inputs(b=1, s=1, t=1))


@pytest.mark.parametrize("case", [
    "src-float64", "tgt-float16", "valid-uint8", "valid-float", "src-rank-2", "tgt-4-channels",
    "valid-shorter", "other-batch", "other-device", "no-target-slot", "src-strided",
    "tgt-transposed", "valid-strided", "slots-past-int32",
])
def test_check_launch_rejects_bad_inputs(case):
    """Each input the kernel cannot take raises ValueError before a launch:
    those of ``test_nn_search_rejects_bad_inputs`` and non-contiguous ones."""
    src, tgt, valid = good_inputs()
    if case == "src-float64":
        src = src.double()
    elif case == "tgt-float16":
        tgt = tgt.half()
    elif case == "valid-uint8":
        valid = valid.to(torch.uint8)
    elif case == "valid-float":
        valid = valid.float()
    elif case == "src-rank-2":
        src = src[0]
    elif case == "tgt-4-channels":
        tgt = torch.ones(2, 8, 4)
    elif case == "valid-shorter":
        valid = valid[:, :4]
    elif case == "other-batch":
        src = torch.zeros(3, 5, 3)
    elif case == "other-device":
        valid = valid.to("meta")
    elif case == "no-target-slot":
        tgt, valid = tgt[:, :0], valid[:, :0]
    elif case == "src-strided":
        src = torch.zeros(2, 10, 3)[:, ::2]
    elif case == "tgt-transposed":
        tgt = torch.ones(2, 3, 8).transpose(1, 2)
    elif case == "valid-strided":
        valid = torch.ones(2, 16, dtype=torch.bool)[:, ::2]
    elif case == "slots-past-int32":
        tgt = torch.ones(1, 1, 3).expand(2, 2**29, 3)
        valid = torch.ones(1, 1, dtype=torch.bool).expand(2, 2**29)
    with pytest.raises(ValueError):
        _check_launch(src, tgt, valid)


@pytest.mark.parametrize("batch,slots,expected", [
    (1, 1, 20 + 4 + 4), (8, 131072, 8 * 131072 * 20 + 8 * 4 + 8 * 64 * 4),
    (2, 2049, 2 * 2049 * 20 + 2 * 4 + 2 * 2 * 4),
])
def test_scratch_holds_packed_targets_indices_and_counts(batch, slots, expected):
    """16 B of packed target and 4 B of index a slot, a count a row and one a
    chunk of 2,048 slots."""
    assert scratch_bytes(batch, slots) == expected


def test_cpu_tensors_dispatch_to_the_plain_version(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args)
        return nn_search_plain(*args)

    monkeypatch.setattr(mod, "nn_search_plain", spy)
    monkeypatch.setattr(mod, "_launcher", lambda: pytest.fail("CPU call reached the kernel"))
    src = torch.tensor([[[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]]])
    tgt = torch.tensor([[[4.0, 5.0, 5.0], [0.5, 0.0, 0.0], [0.5, 0.0, 0.0], [9.0, 9.0, 9.0]]])
    valid = torch.tensor([[True, True, True, False]])
    before = nn_search.launches
    idx, sq = nn_search(src, tgt, valid)
    assert len(calls) == 1 and nn_search.launches == before
    np.testing.assert_array_equal(idx.numpy(), [[1, 0]])
    np.testing.assert_array_equal(sq.numpy(), [[0.25, 1.0]])


def test_workspace_is_kept_per_stream_and_grows_keys_and_scratch_apart(monkeypatch):
    """One (keys, scratch) pair per (device, stream); keys are filled with
    every bit set. A call that needs no more reuses the pair; a larger call
    replaces only the part that is too small."""
    monkeypatch.setattr(mod, "_workspaces", {})
    cpu = torch.device("cpu")
    keys, scratch = mod._workspace(0, 11, 100, 4000, cpu)
    assert keys.dtype == torch.int64 and keys.numel() == 100 and bool((keys == -1).all())
    assert scratch.dtype == torch.uint8 and scratch.numel() == 4000
    again = mod._workspace(0, 11, 60, 1000, cpu)
    assert again[0] is keys and again[1] is scratch
    other = mod._workspace(0, 12, 60, 1000, cpu)
    assert other[0] is not keys and other[0].numel() == 60 and other[1].numel() == 1000
    more_keys = mod._workspace(0, 11, 150, 4000, cpu)
    assert more_keys[1] is scratch and more_keys[0].numel() == 150
    assert bool((more_keys[0] == -1).all())
    more_scratch = mod._workspace(0, 11, 10, 9000, cpu)
    assert more_scratch[0] is more_keys[0] and more_scratch[1].numel() == 9000
    assert mod._workspaces == {(0, 11): more_scratch, (0, 12): other}
