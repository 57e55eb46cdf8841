"""The backbone's layouts on the CPU: the circular pad's plain version in
both layouts, the wrapper's host side, the model's NCHW path and the
gradient all-reduce of channels-last tensors.

The pad's kernel (``csrc/circular_pad.cu``) runs only on the card
(``tests/test_torch_cuda.py``). Here its plain version, which the card's
tests hold the kernel to, must give the same values and gradients on a
channels-last tensor as on an NCHW one, and hand back the input's layout.
The model on the CPU must take the NCHW path and compute what it computed
before the card's path was channels-last: the forward and every gradient
bit-equal to the earlier pad (``torch.cat`` + ``F.pad`` inline), dropout
masks (``torch.rand(shape) < keep``) and mean over dims (2, 3).
"""

import io
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from delora_tpu_torch.models import resnet
from delora_tpu_torch.models.odometry import ModelConfig, OdometryModel
from delora_tpu_torch.ops.cuda import circular_pad as pad_module
from delora_tpu_torch.ops.cuda.circular_pad import circular_pad, circular_pad_plain
from delora_tpu_torch.parallel.dist import BatchShard

torch.set_num_threads(1)

CL = torch.channels_last
PADS = [(1, 0, 0.0), (1, 1, -math.inf), (2, 1, 0.5), (3, 0, 0.0)]


def activations(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 5, 9), (1, 16, 3, 3), (3, 4, 1, 6)],
                         ids=["2x8x5x9", "1x16x3x3", "3x4x1x6"])
@pytest.mark.parametrize("pad_w,pad_h,value", PADS)
def test_plain_pad_in_channels_last_equals_nchw(shape, dtype, pad_w, pad_h, value):
    """Values, layout and gradient of the plain pad on a channels-last tensor
    against the same tensor in NCHW."""
    x = activations(shape, seed=1, dtype=dtype)
    x_nchw = x.clone().requires_grad_()
    x_cl = x.contiguous(memory_format=CL).requires_grad_()
    out_nchw = circular_pad_plain(x_nchw, pad_w, pad_h, value)
    out_cl = circular_pad_plain(x_cl, pad_w, pad_h, value)
    B, C, H, W = shape
    assert out_cl.shape == (B, C, H + 2 * pad_h, W + 2 * pad_w)
    assert out_cl.is_contiguous(memory_format=CL)
    assert out_nchw.is_contiguous()
    assert torch.equal(out_cl, out_nchw)
    # Wrapped columns and constant rows, against numpy.
    ref = np.pad(x.float().numpy(), ((0, 0), (0, 0), (0, 0), (pad_w, pad_w)), mode="wrap")
    ref = np.pad(ref, ((0, 0), (0, 0), (pad_h, pad_h), (0, 0)), constant_values=value)
    np.testing.assert_array_equal(out_cl.float().detach().numpy(), ref)

    grad = activations(out_cl.shape, seed=2, dtype=dtype)
    (g_nchw,) = torch.autograd.grad(out_nchw, x_nchw, grad)
    (g_cl,) = torch.autograd.grad(out_cl, x_cl, grad.contiguous(memory_format=CL))
    assert g_cl.is_contiguous(memory_format=CL)
    assert torch.equal(g_cl, g_nchw)


@pytest.mark.parametrize("pad_w,pad_h", [(1, 0), (1, 1), (2, 1)])
def test_plain_pad_gradient_folds_the_halo_into_the_edge_columns(pad_w, pad_h):
    """The gradient the kernel computes: each input column's own gradient
    plus that of its copies in the halo; the constant rows give none."""
    x = activations((2, 3, 4, 7), seed=3).requires_grad_()
    out = circular_pad_plain(x, pad_w, pad_h, -math.inf)
    grad = activations(out.shape, seed=4)
    (gx,) = torch.autograd.grad(out, x, grad)
    W = x.shape[3]
    rows = grad[:, :, pad_h:pad_h + x.shape[2]]
    want = rows[..., pad_w:pad_w + W].clone()
    want[..., :pad_w] += rows[..., W + pad_w:]
    want[..., W - pad_w:] += rows[..., :pad_w]
    assert torch.equal(gx, want)


def test_cpu_tensors_dispatch_to_the_plain_version(monkeypatch):
    """On the CPU the wrapper is the plain version and launches nothing;
    other devices are refused."""
    monkeypatch.setattr(pad_module, "_launchers",
                        lambda: pytest.fail("the kernel was called for CPU tensors"))
    before = circular_pad.launches_forward, circular_pad.launches_backward
    x = activations((2, 8, 5, 9), seed=5).contiguous(memory_format=CL).requires_grad_()
    out = circular_pad(x, 1, 1, -math.inf)
    assert torch.equal(out, circular_pad_plain(x, 1, 1, -math.inf))
    assert out.is_contiguous(memory_format=CL)
    out.sum().backward()
    assert (circular_pad.launches_forward, circular_pad.launches_backward) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        circular_pad(torch.zeros(1, 1, 1, 1, device="meta"))


@pytest.mark.parametrize("pixel,element,ptrs,vec", [
    (32, 4, (256, 512), 16), (128, 2, (0, 4096), 16), (16, 2, (64, 80), 16),
    (8, 2, (64, 80), 2), (12, 4, (64, 80), 4), (10, 2, (64, 82), 2), (16, 4, (64, 84), 4),
    (48, 2, (64, 66), 2)])
def test_vector_width_divides_the_pixel_and_both_pointers(pixel, element, ptrs, vec):
    """16 bytes a thread where the pixel and both pointers allow it, one
    element otherwise."""
    assert pad_module._vec_bytes(pixel, element, *ptrs) == vec


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_kernel_takes_the_model_element_types_only(dtype):
    assert pad_module._dtype_code(torch.zeros(1, dtype=torch.bfloat16)) == 1
    with pytest.raises(ValueError, match="kernel takes"):
        pad_module._dtype_code(torch.zeros(1, dtype=dtype))


@pytest.mark.parametrize("dtype,value,word", [
    (torch.float32, -math.inf, 0xFF800000), (torch.float32, 0.0, 0),
    (torch.bfloat16, -math.inf, 0xFF80), (torch.bfloat16, 0.0, 0),
    (torch.bfloat16, 0.5, 0x3F00)])
def test_fill_bytes_repeat_the_value_in_its_type(dtype, value, word):
    size = torch.tensor([], dtype=dtype).element_size()
    fill = bytes(pad_module._fill(value, dtype))
    assert len(fill) == 16
    assert fill == word.to_bytes(size, "little") * (16 // size)


def test_shape_check_refuses_what_the_kernel_cannot_pad():
    pad_module._shape_check(torch.zeros(2, 8, 4, 3), 3, 1)
    with pytest.raises(ValueError, match="do not fit"):
        pad_module._shape_check(torch.zeros(2, 8, 4, 3), 4, 0)
    with pytest.raises(ValueError, match=r"\[B, C, H, W\]"):
        pad_module._shape_check(torch.zeros(8, 4, 3), 1, 0)


# The model's CPU path against the forward as it was before the layouts.

def earlier_pad(x, pad_w=1, pad_h=1, height_value=0.0):
    if pad_w:
        x = torch.cat([x[..., -pad_w:], x, x[..., :pad_w]], dim=-1)
    if pad_h:
        x = F.pad(x, (0, 0, pad_h, pad_h), value=height_value)
    return x


def earlier_dropout(x, rate, generator, channels=False, shard=None):
    keep = 1.0 - rate
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channels else x.shape
    if shard is not None:
        shape = (shape[0] * shard.count,) + tuple(shape[1:])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = shard.rows(mask)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def forward_and_grads(model, images, seed):
    model.zero_grad(set_to_none=True)
    t, q = model(*images, generator=torch.Generator().manual_seed(seed))
    (t.square().sum() + q.sum()).backward()
    return [t, q] + [p.grad for p in model.parameters()]


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("features", [False, True])
def test_cpu_model_takes_the_nchw_path_bit_equal_to_before(monkeypatch, dropout, features):
    """A CPU forward counts in ``layout_counts["nchw"]`` and gives, with the
    same seeds, the outputs and every gradient of the earlier forward."""
    model = OdometryModel(ModelConfig(resnet_outputs=32, blocks_per_stage=(1, 1, 1, 1),
                                      channel_divisor=8, use_dropout=dropout,
                                      pre_feature_extraction=features),
                          torch.Generator().manual_seed(7))
    rng = np.random.default_rng(8)
    images = [torch.from_numpy(rng.normal(size=(2, 16, 64, 4)).astype(np.float32))
              for _ in range(2)]
    now = forward_and_grads(model, images, seed=9)
    assert model.layout_counts == {"nhwc": 0, "nchw": 1}
    with monkeypatch.context() as m:
        m.setattr(resnet, "circular_pad", earlier_pad)
        m.setattr(resnet, "dropout", earlier_dropout)
        m.setattr(resnet, "spatial_mean", lambda x: x.mean(dim=(2, 3)))
        before = forward_and_grads(model, images, seed=9)
    assert model.layout_counts == {"nhwc": 0, "nchw": 2}
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert torch.equal(a, b)


def test_spatial_mean_keeps_the_gradient_channels_last():
    x = activations((2, 8, 5, 7), seed=10)
    x_cl = x.contiguous(memory_format=CL).requires_grad_()
    out = resnet.spatial_mean(torch.tanh(x_cl))
    assert torch.equal(out, torch.tanh(x_cl).mean(dim=(2, 3)))
    torch.testing.assert_close(out, torch.tanh(x).mean(dim=(2, 3)), rtol=1e-6, atol=1e-7)
    (g,) = torch.autograd.grad(out.sum(), x_cl)
    assert g.is_contiguous(memory_format=CL)


@pytest.mark.parametrize("channels", [False, True])
def test_dropout_mask_keeps_the_layout_and_the_draws(channels):
    """A channels-last input gets the same masked values as NCHW, from the
    same draws, and stays channels-last."""
    x = activations((4, 8, 5, 7), seed=11)
    a = resnet.dropout(x, 0.2, torch.Generator().manual_seed(12), channels=channels)
    b = resnet.dropout(x.contiguous(memory_format=CL), 0.2,
                       torch.Generator().manual_seed(12), channels=channels)
    assert b.is_contiguous(memory_format=CL) and a.is_contiguous()
    assert torch.equal(a, b)
    shard = BatchShard(1, 2)
    c = resnet.dropout(x[:2].contiguous(memory_format=CL), 0.2,
                       torch.Generator().manual_seed(12), channels=channels, shard=shard)
    d = earlier_dropout(x[:2], 0.2, torch.Generator().manual_seed(12), channels, shard)
    assert c.is_contiguous(memory_format=CL) and torch.equal(c, d)


def test_cpu_model_holds_contiguous_weights_and_loads_channels_last_state():
    """A state dict whose convolution weights are channels-last (as the
    card's model saves them) loads bit-equal into a CPU model, which keeps
    its weights contiguous; moving a model to the CPU makes them so."""
    cfg = ModelConfig(resnet_outputs=32, blocks_per_stage=(1, 1, 1, 1), channel_divisor=8)
    src = OdometryModel(cfg, torch.Generator().manual_seed(13))
    state = {k: (v.contiguous(memory_format=CL) if v.dim() == 4 else v)
             for k, v in src.state_dict().items()}
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    loaded = torch.load(buf, weights_only=True)
    assert any(v.dim() == 4 and not v.is_contiguous() for v in loaded.values())
    dst = OdometryModel(cfg, torch.Generator().manual_seed(14))
    dst.load_state_dict(loaded)
    for (k, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        assert torch.equal(a, b) and b.is_contiguous(), k
    for p in dst.parameters():
        if p.dim() == 4:
            p.data = p.data.contiguous(memory_format=CL)
    dst.to("cpu")
    assert all(p.is_contiguous() for p in dst.parameters())
    assert all(torch.equal(a, b) for a, b in zip(src.parameters(), dst.parameters()))


def test_gradient_all_reduce_keeps_channels_last_in_place():
    """``BatchShard.mean_`` over a group of one (a shard of two, so it
    halves): channels-last and contiguous tensors keep their storage and
    layout, and hold their halves."""
    tensors = [activations((3, 8, 3, 3), seed=15).contiguous(memory_format=CL),
               activations((5, 7), seed=16), activations((4, 2, 1, 1), seed=17)]
    want = [t / 2 for t in tensors]
    ptrs = [t.data_ptr() for t in tensors]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        BatchShard(0, 2).mean_(tensors)
    finally:
        dist.destroy_process_group()
    assert [t.data_ptr() for t in tensors] == ptrs
    assert tensors[0].is_contiguous(memory_format=CL) and not tensors[0].is_contiguous()
    for t, w in zip(tensors, want):
        assert torch.equal(t, w)
