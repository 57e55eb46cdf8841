"""The hard and soft matcher wrappers' host side, on the CPU: their launch
checks, the halo kernels' shared-memory sizes and the soft kernel's choice,
their CPU dispatch, and the arithmetic identities the soft kernel's blend
relies on, replayed on the plain version.

The kernels run only on the card (``tests/test_torch_cuda.py``); here each
test reaches the wrappers' Python with CPU tensors. Results are compared bit
for bit.
"""

import numpy as np
import pytest
import torch

from delora_tpu_torch.ops.cuda import window_match as mod
from delora_tpu_torch.ops.exact import fma_exact
from delora_tpu_torch.ops.cuda.window_match import (
    _check_launch,
    flush_subnormal,
    inv_tau,
    smem_bytes,
    soft_halo_fits,
    soft_smem_bytes,
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


@pytest.mark.parametrize("window,fits", [((1, 1), True), ((5, 9), True), ((9, 17), True),
                                         ((41, 87), True), ((41, 89), False), ((45, 91), False),
                                         ((101, 201), False)])
def test_soft_halo_size_and_kernel_choice(window, fits):
    """The soft halo kernel stages xyz and normal, 32 B a cell: 40,960 B at
    (9, 17). A window whose halo passes a block's 232,448 B takes the global
    kernel; (41, 87) is the widest 41-row window that fits."""
    wv, wu = window
    assert soft_smem_bytes(window) == (8 + wv - 1) * (64 + wu - 1) * 32
    assert soft_halo_fits(window) is fits
    if window == (9, 17):
        assert soft_smem_bytes(window) == 40960


@pytest.mark.parametrize("window", [(5, 9), (45, 91)])
def test_soft_launch_passes_the_kernel_choice(monkeypatch, window):
    """The soft wrapper's one launch: as many arguments as the C function
    declares, the halo flag by shape, inv_tau rounded to float32, one launch
    counted; a CUDA error raises RuntimeError and counts nothing. The kernel
    is replaced by a recorder (no card here)."""
    src, tgt, nrm, _ = fixture_images()
    calls = []

    def launch(*args):
        calls.append(args)
        return launch.err

    launch.err = 0
    monkeypatch.setattr(mod, "_device", lambda t, name: True)
    monkeypatch.setattr(mod, "_launchers", lambda: (None, launch))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    before = window_match_soft.launches
    window_match_soft(src, tgt, nrm, window, 0.3)
    assert window_match_soft.launches == before + 1
    (args,) = calls
    assert len(args) == len(mod._SOFT_ARGTYPES)
    assert args[12:18] == (2, 6, 11, *window, soft_halo_fits(window))
    assert args[18] == inv_tau(0.3)
    launch.err = 700
    with pytest.raises(RuntimeError, match="700"):
        window_match_soft(src, tgt, nrm, window, 0.3)
    assert window_match_soft.launches == before + 1


_TINY = float(np.finfo(np.float32).tiny)


def signed_flush(x):
    """Subnormal values to a zero of their own sign, as ``.ftz`` does."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def soft_as_kernel(src, tgt, nrm, window, sigma, ftz: bool, pen: bool):
    """The soft blend in the plain version's order with the kernel's
    arithmetic (csrc/window_match.cu, header (a) to (c)). Where ``ftz``: the
    weight flushed by a sign-preserving flush (mul.rn.ftz by 1), products
    left unflushed, and each sum flushing its inputs and result to a signed
    zero (add.rn.ftz.f32). Where ``pen``: an unoccupied candidate enters as
    xyz 0 with +inf added inside |d|^2 = fma(dz, dz, fma(dy, dy, fma(dx, dx,
    pen))), occupied ones with pen = +0, and no occupancy test follows.
    -> (outputs, {sums that fell to a negative subnormal, empty cells,
    subnormal weights})."""
    B, H, W, _ = src.shape
    tau = inv_tau(sigma)
    pad = mod._pad_rows(torch.cat([tgt, nrm, mod._target_occupancy(tgt)[..., None]], -1),
                        window)
    best = torch.full((B, H, W), float("inf"))
    acc_w = torch.zeros((B, H, W))
    acc = torch.zeros((B, H, W, 6))
    negative = empty = subnormal = 0

    def add(a, b):
        nonlocal negative
        if not ftz:
            return flush_subnormal(a + flush_subnormal(b))
        total = signed_flush(a) + signed_flush(b)
        negative += int(((total < 0) & (total > -_TINY)).sum())
        return signed_flush(total)

    for _, cand in mod._window(pad, window, H):
        occupied = cand[..., 6] > 0.5
        if pen:
            empty += int((~occupied).sum())
            cand = torch.where(occupied[..., None], cand, 0.0)
            dx, dy, dz = (cand[..., 0:3] - src).unbind(-1)
            term = torch.where(occupied, 0.0, float("inf"))
            sq = fma_exact(dz, dz, fma_exact(dy, dy, fma_exact(dx, dx, term)))
        else:
            sq = mod.squared_distance(cand[..., 0:3] - src)
            sq = torch.where(occupied, sq, float("inf"))
        best = torch.minimum(best, sq)
        w = torch.where(torch.isfinite(sq), torch.exp(-sq * tau), 0.0) if not pen else \
            torch.exp(-sq * tau)
        subnormal += int(((w > 0) & (w < _TINY)).sum())
        w = signed_flush(w) if ftz else flush_subnormal(w)
        acc_w = add(acc_w, w)
        acc = add(acc, w[..., None] * cand[..., 0:6] if ftz
                  else flush_subnormal(w[..., None] * cand[..., 0:6]))
    best = torch.where(acc_w < 1e-30, float("inf"), best)
    blend = flush_subnormal(acc / torch.clamp(acc_w, min=1e-30)[..., None])
    return (best, blend[..., 0:3], blend[..., 3:6]), dict(negative=negative, empty=empty,
                                                           subnormal=subnormal)


def subnormal_fixture(seed=3, b=2, h=6, w=11):
    """Sources near the origin against candidates of four kinds: coordinates
    and normals a few FLT_MIN across (so weighted sums cross zero into
    negative subnormals), points 9.3-10.2 m away (weights normal, subnormal
    or zero at sigma 1), ordinary points, and empty pixels; a corner of far
    and empty pixels, whose windows miss."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, (b, h, w))
    kind[0, 0:3, 0:7] = np.where(kind[0, 0:3, 0:7] == 3, 3, 1)     # windows that miss
    tiny = (rng.uniform(-3, 3, (b, h, w, 3)) * _TINY).astype(np.float32)
    direction = rng.normal(size=(b, h, w, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    far = (direction * rng.uniform(9.3, 10.2, (b, h, w, 1))).astype(np.float32)
    near = rng.normal(0, 0.5, (b, h, w, 3)).astype(np.float32)
    tgt = np.select([kind[..., None] == 0, kind[..., None] == 1, kind[..., None] == 2],
                    [tiny, far, near], 0.0).astype(np.float32)
    nrm = np.where(kind[..., None] == 0, tiny[..., ::-1],
                   rng.normal(size=(b, h, w, 3))).astype(np.float32)
    src = (rng.uniform(-1, 1, (b, h, w, 3)) * np.where(rng.random((b, h, w, 1)) < 0.5, 1e-20,
                                                        0.05)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (src, tgt, nrm))


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("ftz,pen", [(True, False), (False, True), (True, True)],
                         ids=["ftz", "penalty", "kernel"])
def test_soft_kernel_arithmetic_is_bit_equal_to_the_plain_blend(ftz, pen):
    """The soft kernel's identities (csrc/window_match.cu, header (a) to
    (c)), alone and together, give outputs bit-equal to
    window_match_soft_plain, on inputs that make them matter: subnormal
    weights, sums that fall to negative subnormals (which .ftz flushes to -0
    where the plain version gives +0), and unoccupied candidates next to
    occupied ones."""
    src, tgt, nrm = subnormal_fixture()
    ref = window_match_soft_plain(src, tgt, nrm, (3, 5), 1.0)
    out, seen = soft_as_kernel(src, tgt, nrm, (3, 5), 1.0, ftz, pen)
    for a, b in zip(out, ref):
        assert torch.equal(bits(a), bits(b))
    assert seen["negative"] > 0 if ftz else seen["negative"] == 0
    assert seen["empty"] > 0 if pen else seen["empty"] == 0
    assert seen["subnormal"] > 0
    assert torch.isinf(ref[0]).any() and torch.isfinite(ref[0]).any()
    assert (ref[1].abs() < 1e-30).any() and (ref[1].abs() > 0).any()


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
