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
    soft_halo_fits,
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


def launch_counts():
    """The placement wrapper's launch counts: (exact rule, packed rule)."""
    return placement.launches_exact, placement.launches_packed


def one_more(before, packed=False):
    """``before`` with one launch of the ``packed`` or the exact rule added."""
    return (before[0] + (not packed), before[1] + bool(packed))


@pytest.mark.cuda
def test_placement_kernel_bit_equal_to_plain_on_cuda(cuda):
    pix, r, _, pts = pixel_args(cuda, 5, 4096)
    before = launch_counts()
    out = placement(pix, r, pts, H, 64)
    torch.cuda.synchronize()
    assert launch_counts() == one_more(before)
    assert torch.equal(out, placement_plain(pix, r, pts, H, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("append_range", [False, True])
def test_packed_placement_kernel_bit_equal_to_plain_on_cuda(cuda, append_range):
    pix, r, vals, _ = pixel_args(cuda, 4, 2048)
    before = launch_counts()
    out = placement(pix, r, vals, H, 64, packed=True, append_range=append_range)
    torch.cuda.synchronize()
    assert launch_counts() == one_more(before, packed=True)
    assert torch.equal(out, placement_plain(pix, r, vals, H, 64, packed=True,
                                            append_range=append_range))


def check_placement(pix, r, vals, height, width, **kw):
    """One wrapper call: one launch counted under its rule, bit-equal to the
    plain version."""
    before = launch_counts()
    out = placement(pix, r, vals, height, width, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == one_more(before, kw.get("packed", False))
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
    before = launch_counts()
    with torch.cuda.stream(stream):
        out = placement(pix, r, vals, H, 64, packed=True)
    stream.synchronize()
    assert launch_counts() == one_more(before, packed=True)
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
    before = launch_counts()
    with pytest.raises(RuntimeError):
        placement(pix, r, vals, H, 64)
    assert launch_counts() == before
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


def check_nn(src, tgt, valid):
    """One 1-NN wrapper call: one launch counted, bit-equal to the plain
    version. -> (idx, sq)."""
    before = nn_search.launches
    idx, sq = nn_search(src, tgt, valid)
    torch.cuda.synchronize()
    assert nn_search.launches == before + 1
    ref_idx, ref_sq = nn_search_plain(src, tgt, valid)
    assert torch.equal(idx, ref_idx) and torch.equal(sq, ref_sq)
    return idx, sq


@pytest.mark.cuda
def test_nn_search_duplicates_in_different_splits_go_to_the_lower_index(cuda):
    """One source tile and 20,000 target slots: the kernel splits the targets
    across many blocks. Each source sits exactly on a target that has copies
    far apart in index order, so they land in different blocks' ranges."""
    rng = np.random.default_rng(20)
    n_tgt = 20000
    tgt = (rng.normal(size=(1, n_tgt, 3)) * 20).astype(np.float32)
    valid = np.ones((1, n_tgt), dtype=bool)
    homes = np.arange(50, 50 + 64)
    for k, home in enumerate(homes):
        for copy in (home + 6000 + 37 * k, home + 13000 + 11 * k, n_tgt - 1 - k):
            tgt[0, copy] = tgt[0, home]
    src = tgt[:, homes] + np.float32(0.0)
    idx, _ = check_nn(*(torch.from_numpy(a).to(cuda) for a in (src, tgt, valid)))
    assert (idx[0].cpu().numpy() == homes).all()


@pytest.mark.cuda
def test_nn_search_coincident_points_with_negative_distance(cuda):
    """Sources on their targets (d = +0 exactly: the same fma chains) and one
    float32 ulp off them, where |s|^2 + |t|^2 - 2 s.t rounds below 0: the
    order-preserving keys must keep negative winners and their own bits."""
    rng = np.random.default_rng(21)
    pts = (rng.normal(size=(1, 4000, 3)) * 30).astype(np.float32)
    t = torch.from_numpy(pts).to(cuda)
    valid = torch.ones(1, 4000, dtype=torch.bool, device=cuda)
    idx, sq = check_nn(t, t, valid)
    assert (sq == 0).all() and not torch.signbit(sq).any()
    near = torch.from_numpy(np.nextafter(pts, np.float32(np.inf))).to(cuda)
    idx, sq = check_nn(near, t, valid)
    assert (sq < 0).sum() > 100 and torch.equal(idx[0].long(), torch.arange(4000, device=cuda))


@pytest.mark.cuda
def test_nn_search_a_batch_without_valid_targets_between_full_ones(cuda):
    src, tgt, valid = nn_inputs(cuda, 22, 3, 3000, 9000, valid_share=1.0)
    valid[1] = False
    idx, sq = check_nn(src, tgt, valid)
    assert (sq[1] == 1e30).all() and (idx[1] == 0).all() and (sq[0] < 1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_src,n_tgt,n_valid", [
    (1, 1, 1), (1, 1, 0), (2, 17, 15), (2, 17, 16), (2, 17, 17), (7, 1025, 1023), (7, 1025, 1024),
    (7, 1025, 1025), (1025, 2049, 2047), (1025, 2049, 2048), (1025, 2049, 2049),
    (1023, 4097, 4095), (20000, 32768, 32767),
])
def test_nn_search_sizes_one_off_each_group_tile_and_block(cuda, n_src, n_tgt, n_valid):
    """Valid counts one off the fminf group (16), the shared-memory tile
    (1,024) and the count block (2,048); source counts one off a block's
    1,024; and 20,000 sources against 32,767 valid targets, where each
    block's range spans several tiles (the double-buffered copies) and the
    ranges' edges fall inside tiles."""
    src, tgt, _ = nn_inputs(cuda, n_src * 7 + n_valid, 2, n_src, n_tgt)
    rng = np.random.default_rng(n_valid)
    valid = np.zeros((2, n_tgt), dtype=bool)
    for b in range(2):
        valid[b, rng.choice(n_tgt, n_valid, replace=False)] = True
    check_nn(src, tgt, torch.from_numpy(valid).to(cuda))


@pytest.mark.cuda
def test_nn_search_workspace_is_clean_across_batch_sizes(cuda):
    """B = 8, then B = 1, then B = 8 on other data: the winner keys one call
    leaves must be empty for the next, so a stale key would show as a wrong
    winner."""
    big = nn_inputs(cuda, 23, 8, 4000, 12000)
    small = nn_inputs(cuda, 24, 1, 9000, 30000, valid_share=0.9)
    other = nn_inputs(cuda, 25, 8, 4000, 12000)
    for args in (big, small, other, small, big):
        check_nn(*args)


@pytest.mark.cuda
def test_nn_search_on_a_second_stream(cuda):
    from delora_tpu_torch.ops.cuda import nn_search as nn_module

    args = nn_inputs(cuda, 26, 2, 3000, 8000)
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    before = nn_search.launches
    with torch.cuda.stream(stream):
        idx, sq = nn_search(*args)
    stream.synchronize()
    assert nn_search.launches == before + 1
    assert (cuda.index or 0, stream.cuda_stream) in nn_module._workspaces
    ref_idx, ref_sq = nn_search_plain(*args)
    assert torch.equal(idx, ref_idx) and torch.equal(sq, ref_sq)


def check_matcher(src, tgt, nrm, window):
    """Both hard searches on one input, each one launch and bit-equal to its
    plain version: the forward matcher on the target's own occupancy, the
    index search on an occupancy plane that marks a third of the non-empty
    candidates empty (xyz non-zero, plane 0.5 or below)."""
    before = window_match.launches
    out = window_match(src, tgt, nrm, window)
    torch.cuda.synchronize()
    assert window_match.launches == before + 1
    for a, b in zip(out, window_match_plain(src, tgt, nrm, window)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(src.shape[2] + window[1])
    plane = torch.from_numpy(rng.choice(np.float32([0.0, 0.3, 0.5, 0.51, 1.0]),
                                        size=tuple(src.shape[:3]))).to(src.device)
    before = window_match_indices.launches
    k, sq = window_match_indices(src, tgt, plane, window)
    torch.cuda.synchronize()
    assert window_match_indices.launches == before + 1
    ref_k, ref_sq = window_match_indices_plain(src, tgt, plane, window)
    assert torch.equal(k, ref_k) and torch.equal(sq, ref_sq)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(1, 1), (3, 5), (5, 9), (9, 17)])
@pytest.mark.parametrize("height,width", [(16, 37), (64, 720), (64, 2250)])
def test_hard_matcher_halo_at_each_width_and_window(cuda, height, width, window):
    """W = 37 is narrower than a block's halo (64 + wu - 1 columns), so the
    wrap repeats pixels inside one halo; 720 and 2250 leave partial tiles."""
    args = matcher_inputs_hw(cuda, height, width, seed=height * width + window[1])
    check_matcher(*args, window)


def matcher_inputs_hw(cuda, height, width, seed, batch=2, noise=1.0):
    """matcher_inputs at any height: empty rows and blocks, duplicated
    columns, the source a noisy copy held as the xyz slice of a 7-channel
    image."""
    rng = np.random.default_rng(seed)
    tgt = (rng.normal(size=(batch, height, width, 3)) * 4.0).astype(np.float32)
    tgt[rng.random((batch, height, width)) < 0.2] = 0.0
    tgt[:, height // 4: height // 4 + 2] = 0.0
    tgt[:, height // 2:, 10:30] = 0.0
    tgt[:, :, 1::4] = tgt[:, :, 0::4][:, :, : tgt[:, :, 1::4].shape[2]]
    nrm = rng.normal(size=(batch, height, width, 3)).astype(np.float32)
    wide = torch.zeros(batch, height, width, 7, device=cuda)
    wide[..., 0:3] = torch.from_numpy(
        tgt + noise * rng.normal(size=tgt.shape).astype(np.float32)).to(cuda)
    return wide[..., 0:3], torch.from_numpy(tgt).to(cuda), torch.from_numpy(nrm).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(5, 9), (9, 17)])
def test_hard_matcher_ties_across_tile_edges_and_the_wrap(cuda, window):
    """Exact ties between candidates in different blocks' tiles (columns
    63 | 64, rows 7 | 8), in one thread's pair of rows (4 | 5) and across
    two threads' pairs (3 | 4), and across the azimuth wrap (columns W - 1 |
    0), with queries on the first and last rows and columns: the first
    offset in dv-major, du-minor order must win, as in the plain version."""
    height, width = 16, 200
    src, tgt, nrm = matcher_inputs_hw(cuda, height, width, seed=30 + window[1])
    tgt[:, :, 64] = tgt[:, :, 63]
    tgt[:, 8] = tgt[:, 7]
    tgt[:, 4] = tgt[:, 3]
    tgt[:, 5] = tgt[:, 4]
    tgt[:, :, 0] = tgt[:, :, width - 1]
    point = torch.tensor([3.0, -2.0, 1.0], device=cuda)
    for r in (0, 3, 4, 5, 7, 8, height - 1):
        for c in (0, 63, 64, width - 1):
            tgt[:, r, c] = point
    src[:, 0, 0] = point + 0.01
    src[:, height - 1, width - 1] = point - 0.01
    for r, c in ((3, 63), (4, 64), (5, 63), (7, 64), (8, 63)):
        src[:, r, c] = point
    sq, xyz, _ = check_matcher(src, tgt, nrm, window)
    for r, c in ((0, 0), (height - 1, width - 1), (3, 63), (4, 64), (5, 63), (7, 64), (8, 63)):
        assert torch.equal(xyz[:, r, c], point.expand(2, 3))


def check_soft(src, tgt, nrm, window, sigma=0.3):
    """One soft matcher call: one launch counted, best_sq (and so the misses)
    bit-equal to the plain version's, the blends within rtol / atol 1e-5,
    no NaN. -> the kernel's (best_sq, xyz, nrm)."""
    before = window_match_soft.launches
    out = window_match_soft(src, tgt, nrm, window, sigma)
    torch.cuda.synchronize()
    assert window_match_soft.launches == before + 1
    ref = window_match_soft_plain(src, tgt, nrm, window, sigma)
    assert torch.equal(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        assert not torch.isnan(a).any()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(1, 1), (3, 5), (5, 9), (9, 17)])
@pytest.mark.parametrize("height,width", [(16, 37), (16, 64), (64, 720), (64, 2250)])
def test_soft_halo_kernel_at_each_width_and_window(cuda, height, width, window):
    """The soft halo kernel: W = 37 is narrower than a block's halo, 64 one
    tile, 720 and 2250 leave partial tiles; empty rows, an empty block,
    duplicated columns."""
    assert soft_halo_fits(window)
    args = matcher_inputs_hw(cuda, height, width, seed=height * width + window[1] + 1,
                             noise=0.3)
    sq, _, _ = check_soft(*args, window)
    assert torch.isfinite(sq).float().mean() > 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("width", [64, 200])
def test_soft_global_kernel_past_shared_memory(cuda, width):
    """(41, 89): its soft halo passes a block's shared memory, so the
    wrapper takes the global kernel, one launch, same results."""
    assert not soft_halo_fits((41, 89))
    args = matcher_inputs_hw(cuda, 16, width, seed=width + 5, noise=0.3)
    check_soft(*args, (41, 89))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(5, 9), (9, 17), (41, 89)])
def test_soft_empty_block_and_windows_that_underflow(cuda, window):
    """Queries whose windows hold only unoccupied candidates, and queries 5 m
    from every candidate of their window (each weight exp(-25 / 0.09)
    underflows): both miss (best_sq +inf, blends exactly 0), with no NaN.
    At (41, 89) (the global kernel) every candidate is one point and only
    the first row's queries lie on it."""
    height, width = 32, 200
    src, tgt, nrm = matcher_inputs_hw(cuda, height, width, seed=40 + window[1], noise=0.3)
    point = torch.tensor([3.0, -2.0, 1.0], device=cuda)
    far = point + torch.tensor([5.0, 0.0, 0.0], device=cuda)
    if window == (41, 89):
        tgt[:] = point
        tgt[:, 8:12] = 0.0
        src[:] = far
        src[:, 0] = point
        misses = [(slice(None), slice(1, height))]
    else:
        tgt[:, 8:20] = 0.0
        src[:, 12:16] = 1.0
        tgt[:, 24:32, 80:160] = point
        src[:, 28:32, 100:140] = far
        misses = [(slice(None), slice(12, 16)), (slice(None), slice(28, 32), slice(100, 140))]
    sq, xyz, nrm_out = check_soft(src, tgt, nrm, window)
    for block in misses:
        assert torch.isinf(sq[block]).all()
        assert (xyz[block] == 0).all() and (nrm_out[block] == 0).all()
    assert torch.isfinite(sq).any()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(5, 9), (9, 17)])
def test_soft_matcher_ties_across_tile_edges_and_the_wrap(cuda, window):
    """Equal candidates in different blocks' tiles (columns 63 | 64, rows
    7 | 8), in one thread's pair of rows and across two threads' pairs, and
    across the azimuth wrap (columns W - 1 | 0), with queries on the first
    and last rows and columns: each pixel's sums take its offsets in the
    plain version's order."""
    height, width = 16, 200
    src, tgt, nrm = matcher_inputs_hw(cuda, height, width, seed=50 + window[1], noise=0.3)
    tgt[:, :, 64] = tgt[:, :, 63]
    tgt[:, 8] = tgt[:, 7]
    tgt[:, 4] = tgt[:, 3]
    tgt[:, 5] = tgt[:, 4]
    tgt[:, :, 0] = tgt[:, :, width - 1]
    point = torch.tensor([3.0, -2.0, 1.0], device=cuda)
    for r in (0, 3, 4, 5, 7, 8, height - 1):
        for c in (0, 63, 64, width - 1):
            tgt[:, r, c] = point
    src[:, 0, 0] = point + 0.01
    src[:, height - 1, width - 1] = point - 0.01
    for r, c in ((3, 63), (4, 64), (5, 63), (7, 64), (8, 63)):
        src[:, r, c] = point
    sq, _, _ = check_soft(src, tgt, nrm, window)
    for r, c in ((3, 63), (4, 64), (5, 63), (7, 64), (8, 63)):
        assert (sq[:, r, c] == 0).all()


@pytest.mark.cuda
def test_soft_matcher_batch_sizes_and_ragged_tiles(cuda):
    """B = 8, then B = 1, then B = 8 again, on 13 rows (a partial tile of
    rows) viewed out of 16: every call right."""
    src, tgt, nrm = (t[:, :13] for t in matcher_inputs_hw(cuda, 16, 720, seed=60, batch=8,
                                                           noise=0.3))
    for b in (8, 1, 8):
        check_soft(src[:b], tgt[:b], nrm[:b], (5, 9))


@pytest.mark.cuda
def test_soft_matcher_on_a_second_stream(cuda):
    """A call on a side stream launches there and is right once that stream
    is synchronized."""
    args = matcher_inputs_hw(cuda, 16, 720, seed=70, noise=0.3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = window_match_soft(*args, (9, 17), 0.3)
    stream.synchronize()
    ref = window_match_soft_plain(*args, (9, 17), 0.3)
    assert torch.equal(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def street_cloud(seed, rings=64, steps=2000):
    """A ray-cast street (ground, two facades, a far wall; 2 cm range noise,
    5% of rays lost) over a 64-beam sensor, padded to the preprocessing
    capacity at 64x2250 (147,456 points)."""
    rng = np.random.default_rng(seed)
    el = np.deg2rad(np.linspace(-24.5, 2.0, rings))
    az = np.linspace(-math.pi, math.pi, steps, endpoint=False)
    e, a = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1).reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.stack([np.where(d[:, 2] < 0, -1.73 / d[:, 2], np.inf),
                      np.where(d[:, 1] < 0, -7.0 / d[:, 1], np.inf),
                      np.where(d[:, 1] > 0, 9.0 / d[:, 1], np.inf),
                      np.where(d[:, 0] > 0, 60.0 / d[:, 0], np.inf)]).min(0)
    keep = (t < 80.0) & (rng.random(len(t)) > 0.05)
    t = t[keep] + rng.normal(0, 0.02, keep.sum())
    pts = np.zeros((147456, 3), np.float32)
    pts[:keep.sum()] = d[keep] * t[:, None]
    valid = np.zeros(147456, bool)
    valid[:keep.sum()] = True
    return pts, valid


PREPROCESS_SPEC = tproj.ProjectionSpec(height=64, width=2250, **FOV)


@pytest.mark.cuda
def test_exact_placement_at_the_preprocessing_shape(cuda):
    """The exact rule at 64x2250 with N = 147,456 (the KITTI preprocessing
    capacity), ~115k valid: bit-equal to its plain version on the card and on
    the CPU, one launch."""
    pts, valid = street_cloud(80)
    pts, valid = torch.from_numpy(pts).to(cuda)[None], torch.from_numpy(valid).to(cuda)[None]
    r, _, _, _, pix = tproj._pixel_coords(pts, valid, PREPROCESS_SPEC)
    args = (pix.contiguous(), r.contiguous(), pts.contiguous(), 64, 2250)
    before = launch_counts()
    out = placement(*args)
    torch.cuda.synchronize()
    assert launch_counts() == one_more(before)
    assert torch.equal(out, placement_plain(*args))
    assert torch.equal(out.cpu(), placement_plain(*(a.cpu() if torch.is_tensor(a) else a
                                                    for a in args)))
    assert (out[..., 3] > 0).sum() > 100000


@pytest.mark.cuda
def test_normal_image_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """``compute_normal_image`` at 64x2250 with the 7x11 patch on the card
    against the CPU on the same image: the same "has a normal" mask and the
    same covariances bit for bit (exact counts, single-rounded fmas), the
    normals within 4e-6 * kappa where kappa <= 300 (the card's arccos and cos
    may differ from the CPU's in the last bit; ``tests/test_torch_normals.py``
    gives the bound) and within 1e-4 on at least 99.9% of them."""
    from delora_tpu_torch.ops import normals as tnormals

    pts, valid = street_cloud(81)
    proj = tproj.project_scan_batch(torch.from_numpy(pts)[None], torch.from_numpy(valid)[None],
                                    PREPROCESS_SPEC)
    image = proj.image[0, ..., :3].contiguous()
    spec = tnormals.NormalsSpec(7, 11, 0.5, 10)
    covs = []
    solver = tnormals.smallest_eigenvector_sym3x3
    monkeypatch.setattr(tnormals, "smallest_eigenvector_sym3x3",
                        lambda A, eps=1e-20: covs.append(A.cpu()) or solver(A, eps))
    cpu = tnormals.compute_normal_image(image, spec)
    card = tnormals.compute_normal_image(image.to(cuda), spec).cpu()
    assert torch.equal(covs[0], covs[1])
    has = (cpu != 0).any(-1)
    assert torch.equal((card != 0).any(-1), has) and has.sum() > 50000
    w = np.linalg.eigvalsh(covs[0].numpy().astype(np.float64))
    kappa = torch.from_numpy(np.abs(w).max(-1) / np.maximum(w[..., 1] - w[..., 0], 1e-30))
    diff = (card - cpu).abs().amax(-1).double()
    held = has & (kappa <= 300.0)
    assert (diff[held] <= 4e-6 * kappa[held]).all()
    assert (diff[has] <= 1e-4).double().mean() >= 0.999
