"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest pins JAX to the CPU and so imports
it). Each kernel must be bit-equal to its plain version on the same inputs
and count exactly one launch; the soft matcher's squared distances and miss
mask must be bit-equal, and its blends within rtol 1e-5 / atol 1e-5 (metres):
the kernel's expf and torch.exp on the card may differ in the last bit, which
moves a blend by about 1e-7 of the spread of its candidates.
"""

import math

import numpy as np
import pytest
import torch

from delora_tpu_torch.ops import projection as tproj
from delora_tpu_torch.ops.cuda import placement as placement_module
from delora_tpu_torch.ops.cuda.placement import key_bits, placement, placement_plain
from delora_tpu_torch.ops.cuda.nn_search import nn_search, nn_search_plain
from delora_tpu_torch.ops.cuda.window_match import (
    window_match,
    window_match_indices,
    window_match_indices_plain,
    window_match_plain,
    window_match_soft,
    window_match_soft_plain,
)

H = 16
FOV = dict(fov_up=2.0 / 180 * math.pi, fov_down=-24.5 / 180 * math.pi,
           fov_left=-179.9 / 180 * math.pi, fov_right=179.9 / 180 * math.pi)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cloud(seed, n, batch=2):
    """~2-4 points a pixel of a 16x64 sensor, 1/8 exact duplicates (range
    ties), every 8th point followed by one on its ray 1e-4 nearer (16-bit
    near-ties), ~5% invalid."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-math.pi, math.pi, (batch, n))
    el = rng.uniform(FOV["fov_down"] - 0.05, FOV["fov_up"] + 0.05, (batch, n))
    r = rng.uniform(1.0, 60.0, (batch, n))
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1).astype(np.float32)
    for b in range(batch):
        dst = rng.choice(n, n // 8, replace=False)
        pts[b, dst] = pts[b, rng.choice(n, n // 8)]
    pts[:, 1::8] = pts[:, 0::8][:, : pts[:, 1::8].shape[1]] * np.float32(1 - 1e-4)
    valid = rng.random((batch, n)) > 0.05
    vals = rng.normal(size=(batch, n, 7)).astype(np.float32)
    return pts, valid, vals


def pixel_args(cuda, seed, n, width=64):
    pts, valid, vals = cloud(seed, n)
    spec = tproj.ProjectionSpec(height=H, width=width, **FOV)
    r, _, _, _, pix = tproj._pixel_coords(torch.from_numpy(pts).to(cuda),
                                          torch.from_numpy(valid).to(cuda), spec)
    return pix, r, torch.from_numpy(vals).to(cuda), torch.from_numpy(pts).to(cuda)


@pytest.mark.cuda
def test_placement_kernel_bit_equal_to_plain_on_cuda(cuda):
    pix, r, _, pts = pixel_args(cuda, 5, 4096)
    before = placement.launches
    out = placement(pix, r, pts, H, 64)
    torch.cuda.synchronize()
    assert placement.launches == before + 1
    assert torch.equal(out, placement_plain(pix, r, pts, H, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("append_range", [False, True])
def test_packed_placement_kernel_bit_equal_to_plain_on_cuda(cuda, append_range):
    pix, r, vals, _ = pixel_args(cuda, 4, 2048)
    before = placement.launches
    out = placement(pix, r, vals, H, 64, packed=True, append_range=append_range)
    torch.cuda.synchronize()
    assert placement.launches == before + 1
    assert torch.equal(out, placement_plain(pix, r, vals, H, 64, packed=True,
                                            append_range=append_range))


def check_placement(pix, r, vals, height, width, **kw):
    """One wrapper call: one launch counted, bit-equal to the plain version."""
    before = placement.launches
    out = placement(pix, r, vals, height, width, **kw)
    torch.cuda.synchronize()
    assert placement.launches == before + 1
    ref = placement_plain(pix, r, vals, height, width, **kw)
    assert torch.equal(out, ref)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 65537])
def test_packed_placement_on_each_side_of_the_key_width_switch(cuda, n):
    """32-bit keys up to 65,536 points a row, 64-bit beyond. The last point
    of row 0 is the only one in its pixel, so the largest index a 32-bit key
    holds (0xFFFF) must come back as the winner."""
    assert key_bits(True, n) == (32 if n <= 65536 else 64)
    width = 1024
    pix, r, vals, _ = pixel_args(cuda, 6, n, width=width)
    hw = H * width
    q = int(pix[0, -1])
    assert q < hw
    lonely = pix[0] == q
    lonely[-1] = False
    pix[0, lonely] = hw
    for append_range in (False, True):
        ref = check_placement(pix, r, vals, H, width, packed=True, append_range=append_range)
        assert torch.equal(ref[0].reshape(hw, -1)[q, :7], vals[0, -1])


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_placement_with_a_culled_row_and_an_all_empty_call(cuda, packed):
    pix, r, vals, _ = pixel_args(cuda, 7, 2048)
    pix[1] = torch.where(torch.arange(2048, device=cuda) % 2 == 0, -1, H * 64).to(torch.int32)
    ref = check_placement(pix, r, vals, H, 64, packed=packed)
    assert bool((ref[1] == 0).all()) and bool((ref[0] != 0).any())
    empty = torch.full_like(pix, -1)
    ref = check_placement(empty, r, vals, H, 64, packed=packed, append_range=False)
    assert bool((ref == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("append_range", [False, True])
@pytest.mark.parametrize("channels", [1, 3, 7])
def test_placement_channels_and_range_channel(cuda, channels, append_range, packed):
    pix, r, vals, _ = pixel_args(cuda, 8 + channels, 3000)
    vals = vals[..., :channels].contiguous()
    ref = check_placement(pix, r, vals, H, 64, packed=packed, append_range=append_range)
    assert ref.shape == (2, H, 64, channels + append_range)


@pytest.mark.cuda
def test_placement_workspace_is_clean_after_larger_calls(cuda):
    """Large, small, large, across both rules and both key widths: the key
    workspace one call leaves behind must be clean for the next, so a key
    left over from a larger call would show as a wrong winner."""
    big = pixel_args(cuda, 9, 131072, width=720)
    small = pixel_args(cuda, 10, 1500)
    check_placement(*big[:3], H, 720)
    check_placement(*small[:3], H, 64, packed=True)
    check_placement(*big[:3], H, 720, packed=True)
    check_placement(*small[:3], H, 64)
    check_placement(*big[:3], H, 720)
    check_placement(*small[:3], H, 64, packed=True, append_range=False)


@pytest.mark.cuda
def test_placement_on_a_second_stream(cuda):
    pix, r, vals, _ = pixel_args(cuda, 11, 4096)
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    before = placement.launches
    with torch.cuda.stream(stream):
        out = placement(pix, r, vals, H, 64, packed=True)
    stream.synchronize()
    assert placement.launches == before + 1
    assert (cuda.index or 0, stream.cuda_stream) in placement_module._workspaces
    assert torch.equal(out, placement_plain(pix, r, vals, H, 64, packed=True))


@pytest.mark.cuda
def test_placement_error_raises_and_drops_the_workspace(cuda, monkeypatch):
    """A non-zero CUDA error raises RuntimeError (no fallback) and drops the
    cached workspace; the next call builds a fresh one and is right. The
    error is the kernel's refusal of 32-bit keys under the exact rule."""
    pix, r, vals, _ = pixel_args(cuda, 12, 2048)
    check_placement(pix, r, vals, H, 64)
    slot = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    assert slot in placement_module._workspaces
    monkeypatch.setattr(placement_module, "key_bits", lambda packed, n: 32)
    before = placement.launches
    with pytest.raises(RuntimeError):
        placement(pix, r, vals, H, 64)
    assert placement.launches == before
    assert slot not in placement_module._workspaces
    monkeypatch.undo()
    check_placement(pix, r, vals, H, 64)


def matcher_inputs(cuda, width, seed, batch=2, noise=1.0):
    """Target with empty rows, an empty block and duplicated columns (ties);
    the source as the xyz slice of a [B, H, W, 7] image, as the step holds it."""
    rng = np.random.default_rng(seed)
    tgt = (rng.normal(size=(batch, H, width, 4)) * 4.0).astype(np.float32)
    tgt[rng.random((batch, H, width)) < 0.2] = 0.0
    tgt[:, 4:6] = 0.0
    tgt[:, 6:16, 10:40] = 0.0          # wider than a (9, 17) window
    tgt[:, :, 1::4] = tgt[:, :, 0::4][:, :, : tgt[:, :, 1::4].shape[2]]
    nrm = rng.normal(size=(batch, H, width, 3)).astype(np.float32)
    wide = torch.zeros(batch, H, width, 7, device=cuda)
    wide[..., 0:3] = torch.from_numpy(
        tgt[..., :3] + noise * rng.normal(size=(batch, H, width, 3)).astype(np.float32)).to(cuda)
    tgt_t = torch.from_numpy(tgt).to(cuda)
    return wide[..., 0:3], tgt_t[..., 0:3], torch.from_numpy(nrm).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("width,window", [(64, (5, 9)), (37, (3, 5)), (2250, (9, 17))])
def test_window_match_kernel_bit_equal_to_plain_on_cuda(cuda, width, window):
    args = matcher_inputs(cuda, width, seed=width)
    before = window_match.launches
    out = window_match(*args, window)
    torch.cuda.synchronize()
    assert window_match.launches == before + 1
    ref = window_match_plain(*args, window)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.isinf(ref[0]).any() and torch.isfinite(ref[0]).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("width,window", [(64, (5, 9)), (37, (3, 5)), (2250, (9, 17))])
def test_soft_window_match_kernel_matches_plain_on_cuda(cuda, width, window):
    args = matcher_inputs(cuda, width, seed=width + 1, noise=0.3)
    before = window_match_soft.launches
    sq, xyz, nrm = window_match_soft(*args, window, 0.3)
    torch.cuda.synchronize()
    assert window_match_soft.launches == before + 1
    ref_sq, ref_xyz, ref_nrm = window_match_soft_plain(*args, window, 0.3)
    assert torch.equal(sq, ref_sq)
    torch.testing.assert_close(xyz, ref_xyz, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nrm, ref_nrm, rtol=1e-5, atol=1e-5)
    # Misses (the empty block, underflowed windows) and matches both occur.
    assert torch.isinf(ref_sq).any() and torch.isfinite(ref_sq).float().mean() > 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("width,window", [(64, (5, 9)), (37, (3, 5))])
def test_index_kernel_follows_the_occupancy_plane_on_cuda(cuda, width, window):
    """Candidates read their occupancy from a plane of a [B, H, W, 7] image:
    an occupied candidate at xyz exactly 0 can win, an unoccupied one with
    non-zero xyz cannot."""
    src, cand, _ = matcher_inputs(cuda, width, seed=width + 2)
    wide = torch.zeros(src.shape[:3] + (7,), device=cuda)
    wide[..., 0:3] = cand
    wide[..., 6] = (cand != 0).any(-1).float()
    wide[:, 2, 6, 0:3] = 0.0                # occupied at the origin ...
    wide[:, 2, 6, 6] = 1.0
    src[:, 2, 6] = 0.01                     # ... next to this query
    wide[:, 3, 22, 0:3] = 5.0               # not occupied, at this query
    wide[:, 3, 22, 6] = 0.0
    src[:, 3, 22] = 5.0
    before = window_match_indices.launches
    k, sq = window_match_indices(src, wide[..., 0:3], wide[..., 6], window)
    torch.cuda.synchronize()
    assert window_match_indices.launches == before + 1
    ref_k, ref_sq = window_match_indices_plain(src, wide[..., 0:3], wide[..., 6], window)
    assert torch.equal(k, ref_k) and torch.equal(sq, ref_sq)
    center = (window[0] // 2) * window[1] + window[1] // 2
    assert (k[:, 2, 6] == center).all() and (sq[:, 3, 22] > 0).all()


def nn_inputs(cuda, seed, batch, n_src, n_tgt, valid_share=0.4):
    """Targets with every fifth one a duplicate of its neighbour (exact
    ties), about ``valid_share`` valid; the last batch's targets all
    invalid."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(batch, n_src, 3)) * 20).astype(np.float32)
    tgt = (rng.normal(size=(batch, n_tgt, 3)) * 20).astype(np.float32)
    tgt[:, 1::5] = tgt[:, 0::5][:, : tgt[:, 1::5].shape[1]]
    valid = rng.random((batch, n_tgt)) < valid_share
    valid[-1] = False
    return (torch.from_numpy(src).to(cuda), torch.from_numpy(tgt).to(cuda),
            torch.from_numpy(valid).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n_src,n_tgt", [(333, 1777), (5000, 20000), (1, 1)])
def test_nn_search_kernel_bit_equal_to_plain_on_cuda(cuda, n_src, n_tgt):
    args = nn_inputs(cuda, n_src + n_tgt, 3, n_src, n_tgt)
    before = nn_search.launches
    idx, sq = nn_search(*args)
    torch.cuda.synchronize()
    assert nn_search.launches == before + 1
    ref_idx, ref_sq = nn_search_plain(*args)
    assert torch.equal(idx, ref_idx) and torch.equal(sq, ref_sq)
    assert (sq[-1] == 1e30).all() and (idx[-1] == 0).all()
