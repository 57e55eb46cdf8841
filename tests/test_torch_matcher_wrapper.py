"""The hard and soft matcher wrappers' host side, on the CPU: their launch
checks, the hard kernel's shared-memory size, and their CPU dispatch.

The kernels run only on the card (``tests/test_torch_cuda.py``); here each
test reaches the wrappers' Python with CPU tensors. Results are compared bit
for bit.
"""

import numpy as np
import pytest
import torch

from delora_tpu_torch.ops.cuda import window_match as mod
from delora_tpu_torch.ops.cuda.window_match import (
    _check_launch,
    smem_bytes,
    window_match,
    window_match_indices,
    window_match_indices_plain,
    window_match_plain,
    window_match_soft,
    window_match_soft_plain,
)


def good_inputs(b=2, h=4, w=8):
    """The source as the xyz slice of a 7-channel image, as the step holds
    it; the candidates' xyz and normals; an occupancy plane of a wider image."""
    wide = torch.zeros(b, h, w, 7)
    return wide[..., 0:3], torch.ones(b, h, w, 3), torch.ones(b, h, w, 3), wide[..., 6]


def test_check_launch_accepts_what_the_kernels_take():
    src, xyz, nrm, plane = good_inputs()
    for window in ((1, 1), (5, 9), (9, 17)):
        _check_launch(window, src, xyz, nrm, "tgt_nrm")
        _check_launch(window, src, xyz, plane, "cand_occ")
        _check_launch(window, src, xyz, nrm, "tgt_nrm", hard=False)
    _check_launch((5, 9), *good_inputs(b=1, h=1, w=1)[:3], "tgt_nrm")


@pytest.mark.parametrize("case", [
    "src-float64", "xyz-float16", "nrm-rank-3", "plane-rank-4", "xyz-other-shape",
    "src-channels-strided", "xyz-rows-strided", "plane-transposed", "other-device",
    "even-window", "zero-window", "window-halo-too-large", "src-rank-3",
])
def test_check_launch_rejects_bad_inputs(case):
    """Each input the hard kernel cannot take raises ValueError before a
    launch: those of ``test_matcher_rejects_bad_inputs``, views whose
    channels are not contiguous or whose pixels are not evenly spaced, and a
    window whose halo does not fit a block's shared memory."""
    src, xyz, nrm, plane = good_inputs()
    window, third, name = (5, 9), nrm, "tgt_nrm"
    if case == "src-float64":
        src = src.double()
    elif case == "xyz-float16":
        xyz = xyz.half()
    elif case == "nrm-rank-3":
        third = nrm[..., 0]
    elif case == "plane-rank-4":
        third, name = nrm, "cand_occ"
    elif case == "xyz-other-shape":
        xyz = xyz[:, :2]
    elif case == "src-channels-strided":
        src = torch.zeros(2, 4, 8, 6)[..., ::2]
    elif case == "xyz-rows-strided":
        xyz = torch.ones(2, 8, 8, 3)[:, ::2]
    elif case == "plane-transposed":
        third, name = torch.zeros(2, 8, 4).transpose(1, 2), "cand_occ"
    elif case == "other-device":
        xyz = xyz.to("meta")
    elif case == "even-window":
        window = (4, 9)
    elif case == "zero-window":
        window = (5, -1)
    elif case == "window-halo-too-large":
        window = (101, 201)
    elif case == "src-rank-3":
        src = src[0]
    with pytest.raises(ValueError):
        _check_launch(window, src, xyz, third, name)


def test_soft_kernel_takes_windows_beyond_the_hard_kernels_halo():
    src, xyz, nrm, _ = good_inputs()
    assert smem_bytes((101, 201)) > mod._SMEM_LIMIT
    _check_launch((101, 201), src, xyz, nrm, "tgt_nrm", hard=False)


@pytest.mark.parametrize("window,cells", [((5, 9), 12 * 72), ((9, 17), 16 * 80),
                                          ((1, 1), 8 * 64)])
def test_halo_size_follows_the_window(window, cells):
    """A block of 8 x 64 query pixels (256 threads, two rows each) stages
    (8 + wv - 1) x (64 + wu - 1) candidates of 16 B."""
    assert smem_bytes(window) == cells * 16


def fixture_images(seed=0, b=2, h=6, w=11):
    rng = np.random.default_rng(seed)
    tgt = (rng.normal(size=(b, h, w, 3)) * 3).astype(np.float32)
    tgt[rng.random((b, h, w)) < 0.3] = 0.0
    src = tgt + rng.normal(size=tgt.shape).astype(np.float32)
    nrm = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    occ = (rng.random((b, h, w)) < 0.6).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (src, tgt, nrm, occ))


@pytest.mark.parametrize("name", ["window_match", "window_match_indices", "window_match_soft"])
def test_cpu_tensors_dispatch_to_the_plain_versions(monkeypatch, name):
    src, tgt, nrm, occ = fixture_images()
    monkeypatch.setattr(mod, "_launchers", lambda: pytest.fail("CPU call reached the kernel"))
    fn = getattr(mod, name)
    if name == "window_match":
        args, ref = (src, tgt, nrm, (3, 5)), window_match_plain(src, tgt, nrm, (3, 5))
    elif name == "window_match_indices":
        args, ref = (src, tgt, occ, (3, 5)), window_match_indices_plain(src, tgt, occ, (3, 5))
    else:
        args = (src, tgt, nrm, (3, 5), 0.5)
        ref = window_match_soft_plain(*args)
    before = fn.launches
    out = fn(*args)
    assert fn.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_wrappers_name_other_devices():
    src, tgt, nrm, occ = fixture_images()
    meta = [t.to("meta") for t in (src, tgt, nrm, occ)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        window_match(*meta[:3], (3, 5))
    with pytest.raises(ValueError, match="cuda or cpu"):
        window_match_indices(meta[0], meta[1], meta[3], (3, 5))
    with pytest.raises(ValueError, match="cuda or cpu"):
        window_match_soft(*meta[:3], (3, 5), 0.5)



def test_height_limit_is_the_hard_kernels_alone():
    """The hard kernel's grid has a row of tiles per 8 image rows (at most
    65,535); the soft kernel's flat grid has no such limit."""
    rows = mod._MAX_HEIGHT + 1
    src = torch.zeros(1, rows, 1, 3)
    plane = torch.zeros(1, rows, 1)
    _check_launch((1, 1), src, src, src, "tgt_nrm", hard=False)
    with pytest.raises(ValueError, match="rows"):
        _check_launch((1, 1), src, src, plane, "cand_occ")
