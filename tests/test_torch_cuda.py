"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here but ``test_cpu_engine_serves_eagerly_and_captures_nothing``
needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest pins JAX to the CPU and so imports
it). Each kernel must be bit-equal to its plain version on the same inputs
and count exactly one launch; the soft matcher's squared distances and miss
mask must be bit-equal, and its blends within rtol 1e-5 / atol 1e-5 (metres):
the kernel's expf and torch.exp on the card may differ in the last bit, which
moves a blend by about 1e-7 of the spread of its candidates. The serving
engine's CUDA graph must serve the eager forward's transforms bit for bit;
one test holds the engine's CPU path, which captures nothing. The model runs
channels-last on the card: the wrap-pad kernel is bit-equal to its plain
version, a train step runs no cuDNN layout transpose, and the model's loss
and gradients match the same model run NCHW. The trainer's step replayed as
one CUDA graph is bit-equal to its eager step under deterministic kernels,
also after a key of more pixels replaced the placement's key buffer,
follows it within the KITTI train cell's limits at that cell's shapes under
the default kernels, captures once a key, and advances the launch counters
as an eager step. DeLORA's per-image feature extractor with the single head
trains graphed within its own cell's limits of its eager twin and serves
from its graph within the serving cell's limits of the CPU model, its
wrap-pads on the 16-byte path at the published widths and in part on the
one-element path with the backbone cut.
"""

import math
import os

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


@pytest.mark.cuda
def test_source_compaction_at_64x1024_bit_equal_to_plain_on_cuda(cuda, monkeypatch):
    """The raw feed's source compaction at 64x1024 (65,536 pixels, the
    reference's ``project_scan_compact`` branch), B = 8, on KITTI-sized
    clouds with duplicates and range near-ties: one exact-rule launch, and
    the image, the compacted rows and their mask equal to the plain
    version's on the card. (Not to the CPU's: among 8 x 131,072 points the
    card's pixel coordinates put some point on the other side of a rounding
    boundary.)"""
    rng = np.random.default_rng(9)
    spec = tproj.ProjectionSpec(height=64, width=1024, **FOV)
    n = 131072
    az = rng.uniform(-math.pi, math.pi, (8, n))
    el = rng.uniform(FOV["fov_down"] - 0.05, FOV["fov_up"] + 0.05, (8, n))
    r = rng.uniform(1.0, 80.0, (8, n))
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1).astype(np.float32)
    pts[:, 1::8] = pts[:, 0::8] * np.float32(1 - 1e-4)
    pts[:, 2::16] = pts[:, 0::16]
    valid = rng.random((8, n)) > 0.1
    vals = np.concatenate([pts, rng.normal(size=(8, n, 3)).astype(np.float32)], -1)
    args = [torch.from_numpy(x) for x in (pts, valid)]
    before = launch_counts()
    out = tproj.project_compact_exact_batch(*(a.to(cuda) for a in args), spec,
                                            values=torch.from_numpy(vals).to(cuda))
    torch.cuda.synchronize()
    assert launch_counts() == one_more(before)
    monkeypatch.setattr(tproj, "placement", placement_plain)
    ref_card = tproj.project_compact_exact_batch(*(a.to(cuda) for a in args), spec,
                                                 values=torch.from_numpy(vals).to(cuda))
    assert ref_card.comp_mask.sum(1).min() > 40000
    for got, want in zip(out, ref_card):
        assert torch.equal(got, want)


# The serving filter (``serving/stream.py``): a served scan is masked on the
# card, not compacted on the host. The scans below are shared with the CPU
# tests of ``tests/test_torch_serving.py``.

SERVE_OVERRIDES = {
    "kitti": {"max_points": 4096, "vertical_cells": 16, "horizontal_cells": 64},
    "resnet_outputs": 64, "layers": [1, 1, 1, 1],
    "factor_fewer_resnet_channels": 8, "compute_dtype": "float32",
}


def reference_keep(points):
    """The reference's ``filter_scan`` rule (``delora_tpu/serving/stream.py``),
    as its mask: finite x, y, z and ``np.linalg.norm`` >= 0.3."""
    xyz = points[:, :3]
    return np.isfinite(xyz).all(axis=-1) & (np.linalg.norm(xyz, axis=-1) >= 0.3)


def limit_rows(dtype, seed=0):
    """``[K, 3]`` rows at the filter's edges, in ``dtype``: NaN, +-inf and
    zero rows; 0.3 rounded to ``dtype`` and one ulp either side along each
    axis (both signs) and along the two- and three-axis diagonals; and rows
    a few ulps from the limit on which numpy's order of the squared range's
    sum, ``(x*x + y*y) + z*z``, and the other, ``x*x + (y*y + z*z)``,
    disagree about keeping the row."""
    t = dtype(0.3)
    rows = [[np.nan, 1, 1], [1, np.nan, 1], [1, 1, np.nan], [np.inf, 1, 1],
            [1, -np.inf, 1], [1, 1, np.inf], [0, 0, 0], [-0.0, 0, 0]]
    for r in (np.nextafter(t, dtype(0)), t, np.nextafter(t, dtype(1))):
        for axis in range(3):
            for sign in (1, -1):
                row = [0, 0, 0]
                row[axis] = sign * r
                rows.append(row)
    for k in range(-3, 4):
        for axes in (2, 3):
            d = dtype(t / np.sqrt(dtype(axes)))
            for _ in range(abs(k)):
                d = np.nextafter(d, dtype(np.sign(k)))
            rows.append([d, d, d if axes == 3 else 0])
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(20000, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    scale = 1 + np.finfo(dtype).eps * rng.integers(-3, 4, (20000, 1))
    near = (u * 0.3 * scale).astype(dtype)
    sq = near * near
    ordered = np.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2]) >= t
    other = np.sqrt(sq[:, 0] + (sq[:, 1] + sq[:, 2])) >= t
    flips = near[ordered != other]
    assert (ordered[ordered != other]).any() and (~ordered[ordered != other]).any()
    return np.concatenate([np.asarray(rows, dtype), flips[:24], near[:64]])


def edge_scan(dtype, columns=4, n=3000, seed=0):
    """A raw scan ``[M, columns]`` in ``dtype`` for the serving sensor of
    ``SERVE_OVERRIDES``: ``n`` returns in its field of view, with the rows of
    :func:`limit_rows` (about half of them dropped) interleaved, each between
    the two rows of a pair of equal range in one pixel (x and y swapped near
    45 degrees of azimuth, z = 0). Columns past z are random intensities."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-math.pi, math.pi, n)
    el = rng.uniform(FOV["fov_down"] - 0.05, FOV["fov_up"] + 0.05, n)
    r = rng.uniform(1.0, 60.0, n)
    ret = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1).astype(dtype)
    limit = limit_rows(dtype, seed)
    pairs = []
    for k in range(len(limit)):
        a = dtype(rng.uniform(3.0, 30.0))
        b = dtype(a * (1 + 1e-3))
        sx, sy = rng.choice([-1, 1], 2)
        pairs.append([[sx * a, sy * b, 0], limit[k], [sx * b, sy * a, 0]])
    extra = np.asarray(pairs, dtype).reshape(-1, 3)
    at = np.sort(rng.choice(n + 1, len(extra) // 3, replace=True))
    parts, last = [], 0
    for k, cut in enumerate(at):
        parts += [ret[last:cut], extra[3 * k:3 * k + 3]]
        last = cut
    xyz = np.concatenate(parts + [ret[last:]])
    return np.concatenate([xyz, rng.random((len(xyz), columns - 3)).astype(dtype)], -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [3000, 6000])
def test_served_scan_mask_and_image_on_cuda(cuda, dtype, n):
    """On the card, the served scan's mask equals the reference's keep (and
    its first ``max_points`` kept rows past 4,096), and ``push_scan``'s image,
    from one exact launch, equals the image of the scan compacted on the host
    as the engine did before."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.serving.stream import StreamingOdometry, scan_rows

    engine = StreamingOdometry(default_config(SERVE_OVERRIDES), device=cuda)
    points = edge_scan(dtype, n=n, seed=n)
    keep = engine.scan_mask(torch.from_numpy(scan_rows(points)).to(cuda)).cpu().numpy()
    ref = reference_keep(points)
    ref &= np.cumsum(ref) <= engine.max_points
    np.testing.assert_array_equal(keep, ref)
    before = launch_counts()
    assert engine.push_scan(points) is None
    torch.cuda.synchronize()
    assert launch_counts() == one_more(before)
    compact = torch.from_numpy(np.ascontiguousarray(points[ref, :3], np.float32)).to(cuda)
    old = tproj.project_image(compact, torch.ones(len(compact), dtype=torch.bool,
                                                  device=cuda), engine.pspec)
    assert torch.equal(engine._prev_img[0], old)
    assert engine.filter_counts == {"scans": 2, "over_max_points": 2 * int(n > 4096)}


# The served forward as a replayed CUDA graph (``StreamingOdometry._capture``):
# the replay runs the kernels the eager forward runs, so each transform is the
# eager forward's on the same two images, bit for bit.

STEP_KEYS = {"upload", "filter", "project", "forward", "readback", "integrate"}


def eager_pose(model, prev, cur):
    from delora_tpu_torch.training.step import forward_pose

    with torch.no_grad():
        return forward_pose(model, prev, cur)[0].cpu().numpy()


def serve_against_eager(engine, scans):
    """Push ``scans`` through ``engine`` -> (the transforms it served, the
    images it held, from the one it held before), each transform checked
    bit-equal to the eager forward of its model on its two images (one exact
    placement a scan and one replay a pair)."""
    before, replays = launch_counts(), engine.graph_counts["replays"]
    served, images = [], [engine._prev_img.clone()] if engine._prev_img is not None else []
    for points in scans:
        out = engine.push_scan(points)
        images.append(engine._prev_img.clone())
        if out is None:
            continue
        served.append(out[0])
        assert set(engine.step_times) == STEP_KEYS
        np.testing.assert_array_equal(out[0], eager_pose(engine.model, *images[-2:]))
    torch.cuda.synchronize()
    assert launch_counts() == (before[0] + len(scans), before[1])
    assert engine.graph_counts == {"captures": 2, "replays": replays + len(served)}
    return served, images


@pytest.mark.cuda
@pytest.mark.parametrize("overrides,n", [(SERVE_OVERRIDES, 3000), ({}, 60000)],
                         ids=["16x64_fp32", "64x720_bf16"])
def test_served_forward_graph_equals_the_eager_forward_on_cuda(cuda, overrides, n):
    """Seven scans through a CUDA engine at the tests' size (float32) and at
    KITTI's 64x720 under bf16 autocast: every transform is the eager
    forward's, bit for bit. Seeded weights loaded after the capture are
    served from the next pair on, and the transforms equal the eager
    forward's again; the replay is a named span in a trace."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.serving.stream import StreamingOdometry

    config = default_config(overrides)
    engine = StreamingOdometry(config, device=cuda)
    assert engine.graph_counts == {"captures": 2, "replays": 0}
    scans = [edge_scan(np.float32, n=n, seed=s) for s in range(10)]
    assert len(serve_against_eager(engine, scans[:7])[0]) == 6

    old = copy.deepcopy(engine.model)
    engine.model.load_state_dict(OdometryModel(
        ModelConfig.from_config(config), torch.Generator().manual_seed(1)).state_dict())
    served, images = serve_against_eager(engine, scans[7:9])
    for k, T in enumerate(served):
        assert not np.array_equal(T, eager_pose(old, images[k], images[k + 1]))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.push_scan(scans[9])
        torch.cuda.synchronize()
    assert "serving.forward_graph" in {e.key for e in prof.key_averages()}


@pytest.mark.cuda
def test_two_graphed_engines_in_one_process_on_cuda(cuda):
    """A KITTI (64x720) and a DARPA (64x512) engine in one process, their
    scans pushed in turns: each serves the eager forward's transforms and
    what the KITTI engine serves alone."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.serving.stream import StreamingOdometry

    config = default_config()
    scans = [edge_scan(np.float32, n=60000, seed=s) for s in range(6)]
    alone = serve_against_eager(StreamingOdometry(config, device=cuda), scans)[0]
    kitti = StreamingOdometry(config, device=cuda)
    darpa = StreamingOdometry(config, device=cuda, dataset="darpa")
    assert darpa._slots[0].shape == (1, 64, 512, 4)
    together = []
    for k, points in enumerate(scans):
        together += serve_against_eager(kitti, [points])[0]
        serve_against_eager(darpa, [scans[-1 - k]])
    assert len(together) == len(alone) == 5
    assert all(np.array_equal(a, b) for a, b in zip(alone, together))
    assert kitti.graph_counts == darpa.graph_counts == {"captures": 2, "replays": 5}


def test_cpu_engine_serves_eagerly_and_captures_nothing():
    """On the CPU the engine captures no graph and times the same steps of
    ``push_scan`` as before the graph."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.serving.stream import StreamingOdometry

    engine = StreamingOdometry(default_config(SERVE_OVERRIDES), device="cpu")
    assert engine.push_scan(edge_scan(np.float32, seed=0)) is None
    assert set(engine.step_times) == {"upload", "filter", "project"}
    for seed in (1, 2):
        T = engine.push_scan(edge_scan(np.float32, seed=seed))[0]
        assert set(engine.step_times) == STEP_KEYS and np.isfinite(T).all()
    assert engine.graph_counts == {"captures": 0, "replays": 0}


# The backbone runs channels-last on the card (``models/odometry.py``): the
# circular pad is one kernel launch each way (``ops/cuda/circular_pad.py``),
# cuDNN gets NHWC tensors and weights, and no layout is converted.

PAD_CASES = [  # shape [B, C, H, W], dtype, (pad_w, pad_h, value)
    ((32, 8, 64, 720), torch.float32, (1, 0, 0.0)),         # the stem's input
    ((2, 64, 64, 360), torch.bfloat16, (1, 1, -math.inf)),  # the max-pool's
    ((2, 512, 32, 23), torch.bfloat16, (1, 0, 0.0)),        # stage 4
    # One element a thread: pixels that are no multiple of 16 bytes.
    ((3, 5, 7, 11), torch.bfloat16, (2, 1, 0.5)),           # 10-byte pixels
    ((2, 3, 4, 5), torch.float32, (1, 1, -math.inf)),       # 12-byte pixels
    ((2, 4, 6, 9), torch.bfloat16, (3, 1, 2.0)),            # 8-byte pixels
    ((2, 2, 3, 8), torch.float32, (1, 1, -1.0)),            # 8-byte pixels
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,pads", PAD_CASES,
                         ids=["stem", "maxpool", "stage4", "px10_bf16", "px12_fp32", "px8_bf16",
                              "px8_fp32"])
def test_circular_pad_kernel_bit_equal_to_plain_on_cuda(cuda, shape, dtype, pads):
    """The kernel's padded tensor and its input gradient against the plain
    version (``torch.cat`` + ``F.pad`` and their autograd) on the same
    channels-last input, bit for bit; one launch each way, channels-last
    out. An NCHW input is padded to the same values, channels-last."""
    from delora_tpu_torch.ops.cuda.circular_pad import circular_pad, circular_pad_plain

    pad_w, pad_h, value = pads
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    before = (circular_pad.launches_forward, circular_pad.launches_backward)
    out = circular_pad(x, pad_w, pad_h, value)
    ref = circular_pad_plain(x, pad_w, pad_h, value)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert out.shape == ref.shape and torch.equal(out, ref)
    grad = torch.randn(out.shape, generator=g, device=cuda).to(dtype)
    (gx,) = torch.autograd.grad(out, x, grad.contiguous(memory_format=torch.channels_last))
    (gref,) = torch.autograd.grad(ref, x, grad)
    torch.cuda.synchronize()
    assert (circular_pad.launches_forward, circular_pad.launches_backward) == (
        before[0] + 1, before[1] + 1)
    assert gx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(gx, gref)
    nchw = circular_pad(x.detach().contiguous(), pad_w, pad_h, value)
    assert nchw.is_contiguous(memory_format=torch.channels_last) and torch.equal(nchw, ref)


@pytest.mark.cuda
def test_circular_pad_kernel_wraps_a_one_column_image_on_cuda(cuda):
    """W = pad_w = 1: every padded column is the one input column, whose
    gradient sums three columns (in the kernel's order, so within rounding of
    autograd's)."""
    from delora_tpu_torch.ops.cuda.circular_pad import circular_pad, circular_pad_plain

    x = torch.randn(2, 8, 5, 1, device=cuda).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    out = circular_pad(x, 1, 1, -math.inf)
    ref = circular_pad_plain(x, 1, 1, -math.inf)
    assert torch.equal(out, ref)
    grad = torch.randn(out.shape, device=cuda)
    (gx,) = torch.autograd.grad(out, x, grad)
    (gref,) = torch.autograd.grad(ref, x, grad)
    torch.testing.assert_close(gx, gref, rtol=1e-6, atol=1e-6)


def raw_step_batch(cuda, seed, n=30000):
    """A raw-feed batch of two KITTI-sensor pairs (``cloud``'s points, unit
    normals)."""
    from delora_tpu_torch.training.step import ScanPairBatch

    pts, valid, _ = cloud(seed, n)
    rng = np.random.default_rng(seed + 1)
    normals = rng.normal(size=pts.shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    parts = [pts, normals, valid, np.roll(pts, 7, axis=1), normals, valid]
    return ScanPairBatch(*(torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in parts))


def card_model(config, cuda, seed=0):
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel

    return OdometryModel(ModelConfig.from_config(config),
                         torch.Generator().manual_seed(seed)).to(cuda)


def nchw_on_card(monkeypatch):
    """Make the model run NCHW on the card, as before the layouts: the
    layout decided by the device made contiguous, the pad the plain one."""
    from delora_tpu_torch.models import odometry, resnet
    from delora_tpu_torch.ops.cuda.circular_pad import circular_pad_plain

    monkeypatch.setattr(odometry, "backbone_layout", lambda device: torch.contiguous_format)
    monkeypatch.setattr(resnet, "circular_pad", circular_pad_plain)


def device_kernels(prof):
    from torch.autograd import DeviceType

    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.cuda
def test_train_step_runs_channels_last_with_no_layout_kernels_on_cuda(cuda, monkeypatch):
    """One bf16 train step at 64x720, B=2: every convolution's input is
    channels-last (forward pre-hooks), the weights, their gradients and
    Adam's moments too; no cuDNN layout transpose runs; the pads take one
    launch each way; the forward counts as NHWC; and the step launches no
    more device work than the same step run NCHW."""
    from torch.profiler import ProfilerActivity, profile

    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.ops.cuda.circular_pad import circular_pad
    from delora_tpu_torch.training.state import make_optimizer
    from delora_tpu_torch.training.step import StepConfig, train_step

    config = default_config()
    assert config["compute_dtype"] == "bfloat16"
    cfg = StepConfig.from_config(config, supervised=False)
    batch = raw_step_batch(cuda, seed=3)

    def profiled_step(model):
        optimizer = make_optimizer(config, model.parameters(), 2)[0]
        train_step(model, optimizer, batch, cfg)          # warm-up: cuDNN's first calls
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_step(model, optimizer, batch, cfg)
            torch.cuda.synchronize()
        return optimizer, device_kernels(prof)

    model = card_model(config, cuda)
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    seen = []
    for conv in convs:
        conv.register_forward_pre_hook(
            lambda m, args: seen.append(args[0].is_contiguous(memory_format=torch.channels_last)))
    before = (circular_pad.launches_forward, circular_pad.launches_backward)
    optimizer, kernels = profiled_step(model)
    # 17 ConvCirc and the max-pool's pad; the stem's input (the images) has
    # no gradient, so one pad fewer runs backward.
    pads, grads = 17 + 1, 17
    assert (circular_pad.launches_forward - before[0],
            circular_pad.launches_backward - before[1]) == (2 * pads, 2 * grads)
    assert len(seen) == 2 * len(convs) and all(seen)
    assert model.layout_counts == {"nhwc": 2, "nchw": 0}
    for conv in convs:
        w = conv.weight
        for t in (w, w.grad, optimizer.state[w]["exp_avg"], optimizer.state[w]["exp_avg_sq"]):
            assert t.is_contiguous(memory_format=torch.channels_last)
    transposes = [k for k in kernels if "nchwToNhwc" in k or "nhwcToNchw" in k]
    assert not transposes, transposes[:4]
    assert sum("wrap_pad_nhwc" in k for k in kernels) == pads + grads

    nchw_on_card(monkeypatch)
    _, kernels_nchw = profiled_step(card_model(config, cuda))
    print(f"device launches a step: channels-last {len(kernels)}, NCHW {len(kernels_nchw)}; "
          f"NCHW transposes {sum('ToNhwc' in k or 'ToNchw' in k for k in kernels_nchw)}")
    assert len(kernels) <= len(kernels_nchw)


def rel_gap(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def loss_and_grads(model, batch, cfg):
    from delora_tpu_torch.training.step import _LOSS_FNS

    model.zero_grad(set_to_none=True)
    loss, _ = _LOSS_FNS[type(batch)](model, batch, cfg, None, None)
    loss.backward()
    return [loss.detach()] + [p.grad.detach().clone() for p in model.parameters()]


@pytest.mark.cuda
def test_channels_last_model_equals_nchw_on_cuda(cuda, monkeypatch):
    """The supervised loss (smooth in the transforms) and every gradient of
    one model run channels-last and run NCHW on the card, 64x720, B=2: in
    float32 with TF32 off within 1e-5 relative (norm of the gap over the
    norm); in bf16 within 2^-6, four units of bf16's rounding (2^-8; the
    bf16 runs' own gaps from float32 reach 0.069)."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.training.step import StepConfig

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    batch = raw_step_batch(cuda, seed=5)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        config = default_config({"compute_dtype": dtype})
        cfg = StepConfig.from_config(config, supervised=True)
        runs[dtype, "nhwc"] = loss_and_grads(card_model(config, cuda, seed=4), batch, cfg)
        with monkeypatch.context() as m:
            nchw_on_card(m)
            model = card_model(config, cuda, seed=4)
            assert all(p.is_contiguous() for p in model.parameters())
            runs[dtype, "nchw"] = loss_and_grads(model, batch, cfg)
            assert model.layout_counts == {"nhwc": 0, "nchw": 1}
    fp32 = [rel_gap(a, b) for a, b in zip(runs["float32", "nhwc"], runs["float32", "nchw"])]
    bf16 = [rel_gap(a, b) for a, b in zip(runs["bfloat16", "nhwc"], runs["bfloat16", "nchw"])]
    own = [rel_gap(a, b) for a, b in zip(runs["bfloat16", "nhwc"], runs["float32", "nchw"])]
    names = ["loss"] + [k for k, _ in model.named_parameters()]
    for k, a, b, c in zip(names, fp32, bf16, own):
        print(f"gap {k}: fp32 {a:.3g}; bf16 {b:.3g}, bf16's own {c:.3g}")
    assert max(fp32) <= 1e-5
    assert max(bf16) <= 2.0 ** -6


@pytest.mark.cuda
def test_card_state_dict_loads_bit_equal_into_a_cpu_model(cuda):
    """A state dict saved from the card's model (channels-last weights)
    loads bit-equal into a CPU model, which keeps contiguous weights, and a
    CPU model's into a card model, which keeps channels-last ones; a copy
    moved to the CPU holds contiguous weights."""
    import copy
    import io

    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel

    config = default_config(SERVE_OVERRIDES)
    card = card_model(config, cuda, seed=6)
    buf = io.BytesIO()
    torch.save(card.state_dict(), buf)
    buf.seek(0)
    cpu = OdometryModel(ModelConfig.from_config(config), torch.Generator().manual_seed(7))
    cpu.load_state_dict(torch.load(buf, map_location="cpu", weights_only=True))
    for (k, a), (_, b) in zip(card.state_dict().items(), cpu.state_dict().items()):
        assert torch.equal(a.cpu(), b) and b.is_contiguous(), k
    back = card_model(config, cuda, seed=8)
    back.load_state_dict(OdometryModel(ModelConfig.from_config(config),
                                       torch.Generator().manual_seed(9)).state_dict())
    want = OdometryModel(ModelConfig.from_config(config), torch.Generator().manual_seed(9))
    for (k, a), (_, b) in zip(back.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a.cpu(), b), k
        if a.dim() == 4:
            assert a.is_contiguous(memory_format=torch.channels_last)
    assert all(p.is_contiguous() for p in copy.deepcopy(card).cpu().parameters())


# The trainer's step as one replayed CUDA graph (``training/graphed.py``).
# Graphed and eager trainers are twins from one seed; the eager one carries
# a forward hook, which keeps its steps eager. Under deterministic kernels
# (cuDNN's, and a sorted scatter for a gather's backward) two runs of one
# step agree bit for bit, so the graph must too.

TRAIN_SMALL = {"kitti": {"max_points": 4096, "vertical_cells": 16, "horizontal_cells": 64},
               "resnet_outputs": 64, "layers": [1, 1, 1, 1],
               "factor_fewer_resnet_channels": 8, "compute_dtype": "float32",
               "batch_size": 2, "learning_rate": 1e-3, "unsupervised_at_start": True}
RECIPE = {**TRAIN_SMALL, "use_dropout": True, "random_point_cloud_rotations": True,
          "lr_schedule": "cosine", "lr_decay_steps": 9, "ema_decay": 0.9,
          "soft_match_sigma": 0.3, "lambda_reverse_po2pl": 1.0}


@pytest.fixture
def deterministic(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def drive(count, street=False, n=3000, seed=0):
    """``count`` scans with unit normals (a fifth of them zero): ``street``
    clouds (~120k points, 64x720), else ``cloud``'s (16x64)."""
    rng = np.random.default_rng(seed)
    scans = []
    for k in range(count):
        if street:
            pts, valid = street_cloud(seed + k)
            pts = pts[valid]
        else:
            pts, valid, _ = cloud(seed + k, n, batch=1)
            pts = pts[0][valid[0]]
        nrm = rng.normal(size=pts.shape).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm[rng.random(len(pts)) < 0.2] = 0.0
        scans.append((pts, nrm))
    return scans


def twin_trainers(overrides, scans, cuda):
    """(graphed, eager) trainers from one seed; the eager one hooked."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.training.trainer import Trainer

    config = default_config(overrides)
    graphed, eager = (Trainer(config, [scans], device=cuda,
                              generator=torch.Generator().manual_seed(0)) for _ in range(2))
    eager.model.register_forward_hook(lambda *args: None)
    return graphed, eager


def assert_same_state(a, b):
    """Weights, Adam's moments, counts and rate, the EMA and the generators,
    bit for bit."""
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), key
    assert torch.equal(a.optimizer.param_groups[0]["lr"], b.optimizer.param_groups[0]["lr"])
    if a.ema is not None:
        assert all(torch.equal(x, y) for x, y in zip(a.ema.params, b.ema.params))
    for x, y in ((a.dropout_generator, b.dropout_generator),
                 (a.augment_generator, b.augment_generator)):
        if x is not None:
            assert torch.equal(x.get_state(), y.get_state())


def assert_same_epoch(graphed, eager, epoch):
    """Epoch ``epoch`` of each: every step's metrics bit for bit, then the
    states."""
    graphed.train_epoch(epoch)
    eager.train_epoch(epoch)
    for k, v in eager.last_steps.items():
        assert np.array_equal(graphed.last_steps[k], v), (epoch, k, graphed.last_steps[k], v)
        assert np.isfinite(v).all(), (epoch, k)
    assert_same_state(graphed, eager)


GRAPH_CASES = {
    "full_64x720_bf16": ({"batch_size": 2, "unsupervised_at_start": True}, True),
    "full_16x64": (TRAIN_SMALL, False),
    "cached_16x64": ({**TRAIN_SMALL, "cache_source_projections": False}, False),
    "raw_16x64": ({**TRAIN_SMALL, "cache_target_projections": False}, False),
    "projective_16x64": ({**TRAIN_SMALL, "correspondence": "projective"}, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graphed_trainer_equals_the_eager_trainer_on_cuda(cuda, deterministic, case):
    """Three epochs of three steps (B=2): two eager warm-ups, one capture,
    seven replays; every step's loss and metrics, the weights and Adam's
    state bit-equal to the eager trainer's. The fully cached feed at KITTI's
    64x720 in bf16 and every feed at 16x64."""
    overrides, street = GRAPH_CASES[case]
    graphed, eager = twin_trainers(overrides, drive(7, street), cuda)
    assert graphed.feed == {"cached": "cached", "raw": "raw"}.get(case.split("_")[0], "full")
    for epoch in range(3):
        assert_same_epoch(graphed, eager, epoch)
    assert graphed.graph_counts == {"captures": 1, "replays": 7, "eager": 2}
    assert eager.graph_counts == {"captures": 0, "replays": 0, "eager": 9}
    assert isinstance(graphed.optimizer.param_groups[0]["lr"], torch.Tensor)
    assert graphed.optimizer.param_groups[0]["capturable"]


@pytest.mark.cuda
def test_graphed_recipe_draws_as_the_eager_trainer_on_cuda(cuda, deterministic):
    """The quality recipe with augmentation and a cosine schedule (dropout,
    rotations, EMA, soft matching, reverse po2pl): the replays' dropout
    masks and rotations are the eager steps' (the generators stand alike
    after each epoch), the rate falls as eagerly, and every step is
    bit-equal."""
    graphed, eager = twin_trainers(RECIPE, drive(7), cuda)
    rates = []
    for epoch in range(3):
        assert_same_epoch(graphed, eager, epoch)
        rates.append(float(graphed.optimizer.param_groups[0]["lr"]))
    assert rates[0] > rates[1] > rates[2]
    assert graphed.graph_counts == {"captures": 1, "replays": 7, "eager": 2}


def small_batches(trainer, rows):
    feed = trainer.feeds["kitti"]
    idx = np.asarray(rows)
    return trainer.batch(torch.as_tensor(feed.pair_target[idx], device=trainer.device),
                         torch.as_tensor(feed.pair_source[idx], device=trainer.device))


@pytest.mark.cuda
def test_step_graph_captures_once_a_key_and_steps_eagerly_when_it_must_on_cuda(cuda):
    """``graph_counts`` through the supervised-to-unsupervised switch (a key
    each), a half batch (another), a hooked model (eager while hooked),
    ``load_state_dict`` (every graph dropped: warm-ups and a capture again)
    and Adam's state cleared (the graph dropped at its next step)."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.training.step import StepConfig
    from delora_tpu_torch.training.trainer import Trainer

    config = default_config({**TRAIN_SMALL, "unsupervised_at_start": False})
    trainer = Trainer(config, [drive(7)], device=cuda)
    counts = trainer.graph_counts
    sup, unsup = (StepConfig.from_config(config, supervised=s) for s in (True, False))

    def steps(cfg, rows, n=1):
        for _ in range(n):
            out = trainer.step(small_batches(trainer, rows), cfg)
            assert all(torch.isfinite(v) for v in out.values())

    steps(sup, [0, 1], 4)
    assert counts == {"captures": 1, "replays": 2, "eager": 2}
    steps(unsup, [0, 1], 4)
    assert counts == {"captures": 2, "replays": 4, "eager": 4}
    steps(unsup, [4], 3)
    assert counts == {"captures": 3, "replays": 5, "eager": 6}
    steps(sup, [2, 3], 1)
    assert counts == {"captures": 3, "replays": 6, "eager": 6}

    handle = trainer.model.register_forward_pre_hook(lambda *args: None)
    steps(unsup, [0, 1], 2)
    assert counts == {"captures": 3, "replays": 6, "eager": 8}
    handle.remove()
    steps(unsup, [0, 1], 1)
    assert counts == {"captures": 3, "replays": 7, "eager": 8}

    trainer.load_state_dict(trainer.state_dict())
    assert isinstance(trainer.optimizer.param_groups[0]["lr"], torch.Tensor)
    assert trainer.optimizer.param_groups[0]["lr"].device.type == "cuda"
    steps(unsup, [0, 1], 3)
    assert counts == {"captures": 4, "replays": 8, "eager": 10}

    trainer.optimizer.state.clear()
    steps(unsup, [0, 1], 4)
    assert counts == {"captures": 5, "replays": 10, "eager": 12}


def step_launches(trainer, cfg, steps):
    """Each of ``steps`` steps' kernel launches on pairs 0 and 1, as the
    counters that moved and by how much."""
    from delora_tpu_torch.ops.cuda.launches import launch_counts

    deltas = []
    for _ in range(steps):
        before = launch_counts()
        trainer.step(small_batches(trainer, [0, 1]), cfg)
        deltas.append({k: v - before[k] for k, v in launch_counts().items() if v != before[k]})
    return deltas


@pytest.mark.cuda
def test_replayed_steps_count_launches_and_show_in_a_trace_on_cuda(cuda):
    """Every kernel's launch counter advances by as much in a replayed step
    as in an eager one (placement, matcher, wrap-pad both ways), and a
    traced replay shows the ``training.step_graph`` span with the graph's
    hand-written kernels inside."""
    from torch.profiler import ProfilerActivity, profile

    from delora_tpu_torch.training.step import StepConfig

    graphed, eager = twin_trainers(TRAIN_SMALL, drive(7), cuda)
    cfg = StepConfig.from_config(graphed.config, supervised=False)
    per_step = [step_launches(trainer, cfg, 5) for trainer in (graphed, eager)]
    assert graphed.graph_counts == {"captures": 1, "replays": 3, "eager": 2}
    assert per_step[0] == per_step[1] and all(d == per_step[1][0] for d in per_step[1])
    assert {"placement_packed", "window_match", "circular_pad",
            "circular_pad_grad"} <= set(per_step[1][0])

    batch = small_batches(graphed, [2, 3])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graphed.step(batch, cfg)
        torch.cuda.synchronize()
    assert "training.step_graph" in {e.key for e in prof.key_averages()}
    kernels = device_kernels(prof)
    for name in ("window_match_hard", "select_winners", "write_and_reset", "wrap_pad_nhwc"):
        assert any(name in k for k in kernels), (name, sorted(set(kernels))[:20])


@pytest.mark.cuda
def test_replays_keep_their_winner_keys_after_a_key_of_more_pixels_on_cuda(cuda, deterministic):
    """A key of B=2, then one of B=4 (twice the pixels: its warm-up on the
    capture stream replaces the placement's key buffer of that stream), then
    the first key's graph again, with the replaced buffer's size allocated
    and zeroed in between: every step bit-equal to the eager trainer's, as
    the first graph still holds the buffer it captured."""
    from delora_tpu_torch.ops.cuda.placement import workspaces
    from delora_tpu_torch.training.step import StepConfig

    graphed, eager = twin_trainers(TRAIN_SMALL, drive(7), cuda)
    cfg = StepConfig.from_config(graphed.config, supervised=False)

    def steps(rows, n):
        for _ in range(n):
            outs = [t.step(small_batches(t, rows), cfg) for t in (graphed, eager)]
            for k, v in outs[1].items():
                assert torch.equal(outs[0][k], v), (rows, k, outs[0][k], v)

    steps([0, 1], 4)
    before = {w.data_ptr(): w.numel() for w in workspaces()}
    steps([0, 1, 2, 3], 4)
    replaced = {p: n for p, n in before.items()
                if p not in {w.data_ptr() for w in workspaces()}}
    assert replaced, "the wider key made no new key buffer"
    junk = [torch.zeros(n, dtype=torch.int64, device=cuda)
            for n in replaced.values() for _ in range(4)]
    steps([0, 1], 3)
    steps([2, 3, 4, 5], 2)
    del junk
    assert graphed.graph_counts == {"captures": 2, "replays": 9, "eager": 4}
    assert_same_state(graphed, eager)


def cell_limits(workload):
    """The limits of a benchmark cell (``portbench/limits/<workload>.json``)."""
    import json

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "portbench", "limits", f"{workload}.json")) as f:
        return json.load(f)


def follow_from_start(graphed, eager, batches, cfg):
    """Both trainers set back in place to the same start (the eager one's
    weights, Adam's moments and counts at 0), then a step on each of
    ``batches`` -> the gaps the benchmark's training check holds against its
    limits (``portbench/reference/compare.py::training``): each step's loss,
    and each leaf's weight change by the worst leaf."""
    w0 = {k: p.detach().clone() for k, p in eager.model.named_parameters()}
    for t in (graphed, eager):
        with torch.no_grad():
            for k, p in t.model.named_parameters():
                p.copy_(w0[k])
                state = t.optimizer.state.get(p)
                if state:
                    for v in state.values():
                        v.zero_()
    runs = []
    for t in (graphed, eager):
        losses, first = [], None
        for n, rows in enumerate(batches):
            losses.append(float(t.step(small_batches(t, rows), cfg)["loss"]))
            if n == 0:
                first = {k: t.optimizer.state[p]["exp_avg"] / 0.1
                         for k, p in t.model.named_parameters()}
        change = {k: p.detach() - w0[k] for k, p in t.model.named_parameters()}
        runs.append((losses, first, change))

    (g_losses, _, g_change), (e_losses, e_first, e_change) = runs
    assert all(math.isfinite(x) for x in g_losses + e_losses)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(g_losses, e_losses))
    norm = {k: float(torch.linalg.norm(v.double())) for k, v in e_first.items()}
    median = float(np.median(list(norm.values())))
    names = [k for k in norm if norm[k] >= 1e-3 * median]
    p_n = {k: float(torch.linalg.norm(g_change[k].double())) for k in names}
    r_n = {k: float(torch.linalg.norm(e_change[k].double())) for k in names}
    r_median = float(np.median(list(r_n.values())))
    change_gap = max(abs(p_n[k] - r_n[k]) / max(r_n[k], r_median) for k in names)
    return loss_gap, change_gap, (g_losses, e_losses)


@pytest.mark.cuda
def test_graphed_trainer_follows_the_eager_trainer_within_the_train_cell_limits_on_cuda(cuda):
    """The KITTI train cell's shapes and kernels (B=32, 64x720, bf16, the
    default non-deterministic algorithms). Its checked steps are eager, as
    the benchmark hooks the model for them; here the graphed trainer,
    captured, is set back in place to the cell's start (the same weights,
    Adam's moments and counts at 0) beside its eager twin, and three more
    steps on three batches are held as the cell holds the program against
    its reference (``portbench/reference/compare.py::training``, limits of
    ``portbench/limits/kitti-hdl64.train-b32.json``): each step's loss, and
    each leaf's weight change by the worst leaf. The poses a replay computes
    are read by no hook; each step's loss follows them."""
    from delora_tpu_torch.training.step import StepConfig

    limits = cell_limits("kitti-hdl64.train-b32")
    graphed, eager = twin_trainers({"unsupervised_at_start": True}, drive(33, street=True),
                                   cuda)
    assert graphed.batch_size == 32 and graphed.config["compute_dtype"] == "bfloat16"
    assert not torch.are_deterministic_algorithms_enabled()
    cfg = StepConfig.from_config(graphed.config, supervised=False)
    order = np.random.default_rng(0).permutation(32)
    batches = [order, order[::-1], np.roll(order, 7)]
    for _ in range(3):
        graphed.step(small_batches(graphed, batches[0]), cfg)
    assert graphed.graph_counts == {"captures": 1, "replays": 1, "eager": 2}

    loss_gap, change_gap, losses = follow_from_start(graphed, eager, batches, cfg)
    assert graphed.graph_counts == {"captures": 1, "replays": 4, "eager": 2}
    assert eager.graph_counts["captures"] == 0
    assert loss_gap <= limits["loss_gap"], (loss_gap, *losses)
    assert change_gap <= limits["change_gap"], change_gap


# DeLORA's per-image feature extractor and single head (the benchmark's
# ``kitti-hdl64-extractor`` configuration), bf16, at 16x64. At the published
# widths every wrap-pad moves 16 bytes a thread: the extractor's first layer
# pads the float32 image (4 channels, 16 bytes a pixel) before autocast casts
# it for the convolution, and every later pixel is a multiple of 8 bfloat16
# channels. With the backbone cut to a sixteenth of its channels, the stem's
# 4 bfloat16 outputs (8-byte pixels) send the max-pool's pad, stage 1's four
# and stage 2's first (6 a forward, 6 a backward) down the one-element path.
EXTRACTOR_SMALL = {**TRAIN_SMALL, "pre_feature_extraction": True,
                   "use_single_mlp_at_output": True, "layers": [2, 2, 2, 2],
                   "resnet_outputs": 1000, "factor_fewer_resnet_channels": 1,
                   "compute_dtype": "bfloat16", "learning_rate": 1e-5}
# case -> (overrides, one-element pads a forward).
EXTRACTOR_CASES = {"published": (EXTRACTOR_SMALL, 0),
                   "cut_16": ({**EXTRACTOR_SMALL, "factor_fewer_resnet_channels": 16}, 6)}
# The extractor's five pads an image, the stem's, the max-pool's and two a
# block; backward all but the two that read an image.
EXTRACTOR_PADS = (28, 26)


def pad_launches(counts):
    """The wrap-pad's launches of one step, of the ``launch_counts`` deltas."""
    forward, backward = EXTRACTOR_PADS
    return ({k: v for k, v in counts.items() if k.startswith("circular_pad")}
            == {"circular_pad": forward, "circular_pad_grad": backward})


def vector_widths(monkeypatch):
    """The bytes a thread moves in each wrap-pad launched from here on (16,
    or one element), in a list that grows as the wrapper picks them."""
    import importlib

    pad = importlib.import_module("delora_tpu_torch.ops.cuda.circular_pad")
    picked, pick = [], pad._vec_bytes

    def recorded(*args):
        picked.append(pick(*args))
        return picked[-1]

    monkeypatch.setattr(pad, "_vec_bytes", recorded)
    return picked


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXTRACTOR_CASES))
def test_graphed_extractor_step_follows_the_eager_step_within_its_cell_limits_on_cuda(
        cuda, case, monkeypatch):
    """The extractor and single head trained graphed (one capture, then
    replays) beside an eager twin under the default kernels: every step's
    launches equal, and each eager step's wrap-pads by path as stated above;
    then three steps from one start within the limits of the benchmark's
    ``kitti-hdl64-extractor.train-b32`` cell."""
    from delora_tpu_torch.training.step import StepConfig

    overrides, element = EXTRACTOR_CASES[case]
    limits = cell_limits("kitti-hdl64-extractor.train-b32")
    graphed, eager = twin_trainers(overrides, drive(7), cuda)
    assert graphed.model.feature_extractor is not None
    assert hasattr(graphed.model, "fully_connected_rot_trans")
    cfg = StepConfig.from_config(graphed.config, supervised=False)
    per_step = [step_launches(graphed, cfg, 5)]
    picked = vector_widths(monkeypatch)
    per_step.append(step_launches(eager, cfg, 5))
    assert graphed.graph_counts == {"captures": 1, "replays": 3, "eager": 2}
    assert per_step[0] == per_step[1] and all(d == per_step[1][0] for d in per_step[1])
    assert pad_launches(per_step[0][-1]), per_step[0][-1]
    assert len(picked) == 5 * sum(EXTRACTOR_PADS)
    assert sum(v != 16 for v in picked) == 5 * 2 * element

    batches = [[0, 1], [2, 3], [4, 5]]
    loss_gap, change_gap, losses = follow_from_start(graphed, eager, batches, cfg)
    assert graphed.graph_counts == {"captures": 1, "replays": 6, "eager": 2}
    assert loss_gap <= limits["loss_gap"], (loss_gap, *losses)
    assert change_gap <= limits["change_gap"], change_gap


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXTRACTOR_CASES))
def test_graphed_extractor_forward_serves_the_cpu_models_poses_on_cuda(cuda, case,
                                                                      monkeypatch):
    """``StreamingOdometry`` with the extractor and single head: its capture
    (three eager forwards and two graphs) launches the wrap-pad forward
    only, by path as stated above; every served transform equals the card's
    eager forward bit for bit, and holds to the CPU model's float32 forward
    within the serving cell's limits (``portbench/limits/
    darpa-os1-64.serve-10hz.json``), in units of how far the CPU model in
    bfloat16 moves each pair (``portbench/reference/compare.py::pose_gaps``)."""
    from delora_tpu_torch.config import default_config
    from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
    from delora_tpu_torch.ops.cuda.launches import launch_counts
    from delora_tpu_torch.serving.stream import StreamingOdometry
    from delora_tpu_torch.training.step import forward_pose
    from portbench.reference.compare import pose_gaps

    overrides, element = EXTRACTOR_CASES[case]
    limits = cell_limits("darpa-os1-64.serve-10hz")
    config = default_config(overrides)
    before = launch_counts()
    picked = vector_widths(monkeypatch)
    engine = StreamingOdometry(config, device=cuda)
    torch.cuda.synchronize()
    captured = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    assert captured == {"circular_pad": 5 * EXTRACTOR_PADS[0]}
    assert len(picked) == 5 * EXTRACTOR_PADS[0]
    assert sum(v != 16 for v in picked) == 5 * element
    served, images = serve_against_eager(engine, [edge_scan(np.float32, seed=s)
                                                  for s in range(7)])
    assert len(served) == 6 and engine.graph_counts == {"captures": 2, "replays": 6}

    state = {k: v.cpu() for k, v in engine.model.state_dict().items()}
    transforms = {}
    for dtype in ("float32", "bfloat16"):
        model = OdometryModel(ModelConfig.from_config({**config, "compute_dtype": dtype}))
        model.load_state_dict(state)
        with torch.no_grad():
            transforms[dtype] = np.concatenate([
                forward_pose(model.eval(), a.cpu(), b.cpu()).double().numpy()
                for a, b in zip(images[:-1], images[1:])])
    gaps = pose_gaps(np.stack(served).astype(np.float64), transforms["float32"],
                     transforms["bfloat16"])
    assert gaps["rot"] <= limits["rel_rot_gap"], gaps
    assert gaps["trans"] <= limits["rel_trans_gap"], gaps
