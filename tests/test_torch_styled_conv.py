"""The unmasked StyledConv's one-launch path (``ops/styled_conv.py``) and its
routing (``models/stylegan2.py::StyledConv``), on the CPU: the plain
version against the modules it replaces bit for bit, the wrapper's checks,
the gradient through ``kernel_lib.PlainGrad``, the packed weight (the four
polyphase weights side by side along N) and the kernel's arithmetic
replayed from it, and which layers of the generator take the kernel. The
kernel itself runs only on a card (``tests/test_torch_cuda.py``)."""

import math
import types

import pytest
import torch
import torch.nn.functional as F

from e4s_tpu_torch.models.layers import init_module_
from e4s_tpu_torch.models.stylegan2 import Generator, StyledConv
from e4s_tpu_torch.ops import styled_conv as sc
from e4s_tpu_torch.ops.kernel_lib import cached, with_plain_grad
from e4s_tpu_torch.ops.modconv import demod_coeff
from e4s_tpu_torch.ops.patch_modconv import packed_shape

NOISE = ["none", "batch 1", "batch B"]


def _layer(Ci, Co, up, nw, seed=0):
    """A seeded unmasked StyledConv with a nonzero bias and noise strength
    ``nw``."""
    g = torch.Generator().manual_seed(seed)
    m = init_module_(StyledConv(Ci, Co, 3, 16, upsample=up), g)
    with torch.no_grad():
        m.activate.bias.normal_(generator=g)
        m.noise.weight.fill_(nw)
    return m


def _inputs(m, B, H, W, noise, seed=1):
    """x [B,Ci,H,W] channels-last, the style [B,16], the noise map."""
    g = torch.Generator().manual_seed(seed)
    Ci = m.conv.weight.shape[2]
    x = torch.randn((B, Ci, H, W), generator=g).contiguous(memory_format=torch.channels_last)
    style = torch.randn((B, 16), generator=g)
    f = 2 if m.conv.upsample else 1
    nb = {"none": 0, "batch 1": 1, "batch B": B}[noise]
    nz = torch.randn((nb, 1, f * H, f * W), generator=g) if nb else None
    return x, style, nz


def _args(m, style):
    conv = m.conv
    return conv.weight[0] * conv.scale, conv.modulation(style)


def _call(m, x, style, nz, fn=None):
    """``fn`` (the wrapper by default) with the layer's own tensors, as
    ``StyledConv.forward`` passes them."""
    conv = m.conv
    w, s = _args(m, style)
    return (fn or sc.styled_conv3)(
        x, w, s, nz, m.noise.weight, m.activate.bias, up=conv.upsample,
        blur_kernel=conv.blur.kernel if conv.upsample else conv.blur_kernel)


@pytest.mark.parametrize("nw", [0.0, 0.7])
@pytest.mark.parametrize("noise", NOISE)
@pytest.mark.parametrize("up", [False, True])
def test_plain_is_the_modules_bit_for_bit(up, noise, nw):
    """The plain version (the wrapper on the CPU) equals ``ModulatedConv2d``
    -> ``NoiseInjection`` -> ``FusedLeakyReLU`` bit for bit, stride 1 and
    up, noise of batch 1 and of batch B or none, a zero and a nonzero noise
    strength; it launches nothing."""
    m = _layer(12, 8, up, nw)
    x, style, nz = _inputs(m, 3, 5, 7, noise)
    with torch.no_grad():
        want = m.activate(m.noise(m.conv(x, style), nz))
        before = sc.styled_conv3.launches
        got = _call(m, x, style, nz)
        assert torch.equal(got, want)
        assert torch.equal(m(x, style, None, noise=nz), want)
        assert sc.styled_conv3.launches == before


def _unpack(packed, N, Ci, bn):
    """The [N,Ci,3,3] weight (hi + lo) from ``styled_conv_weights``'s tiles."""
    _, nk, nco = packed.shape[:3]
    t = (packed[:, :, :, 0] + packed[:, :, :, 1])[0]  # [nk,nco,9,bn/8,2,8,4]
    t = t.permute(2, 1, 3, 5, 0, 4, 6).reshape(9, nco * bn, nk * 8)
    return t[:, :N, :Ci].reshape(3, 3, N, Ci).permute(2, 3, 0, 1)


@pytest.mark.parametrize("noise", NOISE)
@pytest.mark.parametrize("B,H,W,Ci,Co,up", [(2, 5, 7, 12, 8, True), (1, 6, 4, 8, 40, True),
                                            (2, 5, 7, 20, 24, False), (1, 3, 9, 4, 72, False)])
def test_kernel_arithmetic_from_the_packed_weight_is_the_plain_layer(B, H, W, Ci, Co, up,
                                                                     noise):
    """What the kernel computes, replayed from its packed weight in float64:
    x * s, one stride-1 conv with the P * Co columns of the tiles (P = 4
    phases side by side for ``up``), each column phase * Co + o scattered to
    output pixel (2h + a, 2w + b), then d, the noise, the bias, the
    LeakyReLU and the gain. It is the plain layer up to the weight's TF32
    split (~2^-21) and the fold's float32 rounding."""
    m = _layer(Ci, Co, up, 0.7).double()
    x, style, nz = _inputs(m, B, H, W, noise)
    x, nz = x.double(), None if nz is None else nz.double()
    with torch.no_grad():
        w, s = _args(m, style.double())
        bn = sc.tile_n(Co, up)
        packed = sc.styled_conv_weights(w.float(), up, m.conv.blur_kernel)
        P = 4 if up else 1
        assert packed.shape == packed_shape(1, P * Co, Ci, torch.float32, bn)
        wk = _unpack(packed, P * Co, Ci, bn).double()
        y = F.conv2d(x * s[:, :, None, None], wk, padding=1)
        y = y.reshape(B, P, Co, H, W) * demod_coeff(w, s)[:, None, :, None, None]
        out = y[:, 0]
        if up:
            out = torch.empty((B, Co, 2 * H, 2 * W), dtype=y.dtype)
            for ph in range(P):
                out[:, :, ph >> 1::2, ph & 1::2] = y[:, ph]
        if nz is not None:
            out = out + m.noise.weight * nz
        out = F.leaky_relu(out + m.activate.bias[:, None, None], 0.2) * math.sqrt(2)
        want = _call(m, x, style.double(), nz, fn=sc.styled_conv3_plain)
    assert (out - want).abs().max() <= 2e-6 * want.abs().max()


def test_wrapper_checks_its_inputs():
    """Wrong shapes, dtypes and devices raise before anything runs."""
    m = _layer(8, 16, True, 0.5)
    x, style, nz = _inputs(m, 2, 4, 4, "batch B")
    w, s = _args(m, style)
    nw, bias = m.noise.weight, m.activate.bias
    call = lambda *a, up=True: sc.styled_conv3(*a, up=up)  # noqa: E731
    before = sc.styled_conv3.launches
    with torch.no_grad():
        call(x, w, s, nz, nw, bias)
        bad = [
            (ValueError, (x[0], w, s, nz, nw, bias)),  # x not 4-D
            (TypeError, (x.double(), w, s, nz, nw, bias)),  # dtype
            (TypeError, (x, w.double(), s, nz, nw, bias)),
            (ValueError, (x, w[:, :4].contiguous(), s, nz, nw, bias)),  # Ci
            (ValueError, (x, w, s[:1], nz, nw, bias)),  # batch
            (ValueError, (x, w, s, nz, nw, bias[:8])),  # Co
            (ValueError, (x, w, s, nz[:, :, :4], nw, bias)),  # noise at the input size
            (ValueError, (x, w, s, torch.cat([nz, nz]), nw, bias)),  # noise batch
            (ValueError, (x, w.to("meta"), s, nz, nw, bias)),  # device
            (ValueError, (x, w, s, nz, nw.to("meta"), bias)),
            (ValueError, (x, w, s, nz.transpose(2, 3), nw, bias)),  # not contiguous
        ]
        for err, args in bad:
            with pytest.raises(err):
                call(*args)
        with pytest.raises(ValueError):  # the stride-1 layer's noise is at 4x4
            call(x, w, s, nz, nw, bias, up=False)
        with pytest.raises(ValueError):  # Ci not a multiple of 4
            sc.styled_conv3(x[:, :6], w[:, :6].contiguous(), s[:, :6].contiguous(),
                            None, nw, bias)
        with pytest.raises(ValueError, match="CUDA"):
            sc._launch(x, w, s, nz, nw, bias, None, True, (1, 3, 3, 1))
    assert sc.styled_conv3.launches == before


@pytest.mark.parametrize("noise", ["none", "batch 1"])
@pytest.mark.parametrize("up", [False, True])
def test_gradient_through_plain_grad_is_the_plain_compositions(monkeypatch, up, noise):
    """With the launch replaced by the plain version, the gradients through
    ``kernel_lib.with_plain_grad`` w.r.t. x, the weight, the style, the
    noise strength and the bias are those of autograd through the
    modules."""
    def launch(x, w, s, nz, nw, bias, packed, up, blur_kernel):
        return sc.styled_conv3_plain(x, w, s, nz, nw, bias, up=up, blur_kernel=blur_kernel)

    monkeypatch.setattr(sc, "_launch", launch)
    m = _layer(8, 12, up, 0.5)
    x, style, nz = _inputs(m, 2, 5, 6, noise)
    x.requires_grad_(True)
    r = torch.randn((2, 12) + ((10, 12) if up else (5, 6)),
                    generator=torch.Generator().manual_seed(4))
    wrt = [x, m.conv.weight, m.conv.modulation.weight, m.activate.bias]
    if nz is not None:
        wrt.append(m.noise.weight)
    want = torch.autograd.grad((m.activate(m.noise(m.conv(x, style), nz)) * r).sum(), wrt)
    conv = m.conv
    w, s = _args(m, style)
    nw = m.noise.weight if nz is not None else None
    plain = lambda *t: sc.styled_conv3_plain(  # noqa: E731
        *t, up=up, blur_kernel=conv.blur.kernel if up else conv.blur_kernel)
    out = with_plain_grad(sc._launch, plain, (x, w, s, nz, nw, m.activate.bias),
                          None, up, conv.blur_kernel)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * r).sum(), wrt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _fake(device, dtype, ci):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(1, ci, 8, 8))


@pytest.mark.parametrize("device,dtype,ci,up,taps,want", [
    ("cuda", torch.float32, 128, True, (1, 3, 3, 1), True),
    ("cuda:1", torch.float32, 32, False, (1, 3, 3, 1), True),
    ("cpu", torch.float32, 128, True, (1, 3, 3, 1), False),
    ("cuda", torch.bfloat16, 64, False, (1, 3, 3, 1), False),
    ("cuda", torch.float32, 6, False, (1, 3, 3, 1), False),
    ("cuda", torch.float32, 64, True, (1, 2, 1), False),
    ("cuda", torch.float32, 64, False, (1, 2, 1), True)])
def test_kernel_takes_cuda_f32_and_the_polyphase_blur(device, dtype, ci, up, taps, want):
    """A map of noise a pixel (float32, contiguous) or none goes with the
    input; the edit's full-channel noise, and grad mode on (a training or
    inversion step), take the plain layer whatever the input."""
    x = _fake(device, dtype, ci)
    one, full = torch.zeros((1, 1, 8, 8)), torch.zeros((1, 16, 8, 8))
    for noise in (None, one, one.expand(2, 1, 8, 8).contiguous()):
        assert sc.kernel_takes(x, noise, 3, True, up, taps, False) is want
    for noise in (full, one.double(), one.expand(2, 1, 8, 8)):
        assert not sc.kernel_takes(x, noise, 3, True, up, taps, False)
    assert not sc.kernel_takes(x, None, 3, True, up, taps, True)
    assert not sc.kernel_takes(x, None, 1, True, up, taps, False)
    assert not sc.kernel_takes(x, None, 3, False, up, taps, False)


@pytest.mark.parametrize("K,out_size,want", [
    (13, 1024, [(128, 64, True), (64, 64, False), (64, 32, True), (32, 32, False)]),
    (13, 512, [(128, 64, True), (64, 64, False)]),
    (13, 256, []), (11, 512, [(256, 128, True), (128, 128, False),
                              (128, 64, True), (64, 64, False)])])
def test_the_unmasked_styled_convs_of_the_generator(K, out_size, want):
    """Layers from K on are the unmasked StyledConvs that take the kernel:
    at 1024^2 and K = 13 the four at 512^2 and 1024^2, with their N tiles
    (the up layers' four phases in blocks of 64 columns, 8 x 16 pixels; the
    64-channel layer in one block of 64; the 32-channel layer in one block
    of 32, 16 x 16 pixels)."""
    with torch.device("meta"):
        G = Generator(out_size, remaining_layer_idx=K)
    convs = [m for m in G.modules() if isinstance(m, StyledConv) and not m.mask_op]
    got = [(m.conv.weight.shape[2], m.conv.weight.shape[1], m.conv.upsample)
           for m in convs]
    assert got == want
    if out_size == 1024 and K == 13:
        assert [sc.tile_n(Co, up) for _, Co, up in got] == [64, 64, 64, 32]


def test_styled_conv_caches_its_packed_weight():
    """The packed weight is built once per weight and rebuilt after an
    in-place change (``load_state_dict``, an optimizer step)."""
    m = _layer(8, 16, True, 0.0)
    m.conv.weight.requires_grad_(False)
    w = lambda: m.conv.weight[0] * m.conv.scale  # noqa: E731

    def packed():
        return cached(m, (m.conv.weight,),
                      lambda: sc.styled_conv_weights(w(), True, m.conv.blur_kernel))

    a = packed()
    assert packed() is a
    with torch.no_grad():
        m.conv.weight.mul_(2)
    b = packed()
    assert b is not a
    torch.testing.assert_close(b, sc.styled_conv_weights(w(), True, m.conv.blur_kernel))
