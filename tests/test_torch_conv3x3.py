"""The plain 3x3 conv of the IR-SE trunks (``ops/conv3x3.py``) and its
routing (``models/encoders.py::Conv3x3``), on the CPU: the plain NHWC
version against ``F.conv2d``, the routing predicate over FSEncoderPSP's
convs (a meta-device model), the encoder's CPU output and keys against the
``nn.Conv2d`` trunk it replaces, the channels-last InstanceNorm, the launch
plan, the wrapper's checks and the autograd Function's backward. The
kernel itself runs only on a card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from e4s_tpu_torch.models.encoders import (
    BottleneckIRSE,
    Conv3x3,
    FSEncoderPSP,
    InstanceNorm,
    IRSE50Backbone,
)
from e4s_tpu_torch.models.layers import init_module_
from e4s_tpu_torch.ops import conv3x3 as c3
from e4s_tpu_torch.ops.kernel_lib import cached, with_plain_grad
from e4s_tpu_torch.ops.patch_modconv import pack_weight


@pytest.mark.parametrize("B,H,W,Ci,Co", [(1, 5, 7, 4, 8), (2, 8, 8, 12, 20),
                                         (2, 3, 9, 16, 3)])
def test_plain_nhwc_matches_conv2d(B, H, W, Ci, Co):
    g = torch.Generator().manual_seed(B * 100 + H)
    x = torch.randn((B, H, W, Ci), generator=g)
    w = torch.randn((Co, Ci, 3, 3), generator=g)
    want = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), w, padding=1)
    got = c3.conv3x3_nhwc(x, w)
    assert got.shape == (B, H, W, Co)
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=1e-5, atol=1e-5)
    # the CPU takes the plain version, and launches nothing
    before = c3.conv3x3_nhwc.launches
    assert torch.equal(got, c3.conv3x3_nhwc_plain(x, w))
    assert c3.conv3x3_nhwc.launches == before


def _trunk_convs():
    with torch.device("meta"):
        enc = FSEncoderPSP()
    return [m for m in enc.modules() if isinstance(m, nn.Conv2d)]


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.float32, 44), ("cuda:1", torch.float32, 44),
    ("cpu", torch.float32, 0), ("cuda", torch.bfloat16, 0),
    ("cuda", torch.float16, 0), ("cpu", torch.bfloat16, 0)])
def test_routing_sends_the_44_stride1_convs_on_cuda_f32(device, dtype, want):
    """Of FSEncoderPSP's 3x3 convs, exactly the 44 stride-1 ones go to the
    kernel on a CUDA float32 input; none on the CPU or in bf16, and never
    the 4 stride-2 convs or the 3->64 input conv."""
    convs = _trunk_convs()
    three = [m for m in convs if m.kernel_size == (3, 3)]
    assert len(three) == 49  # the input conv, 24 units x 2
    assert sum(isinstance(m, Conv3x3) for m in three) == 48
    taken = [m for m in three
             if isinstance(m, Conv3x3) and c3.kernel_takes(device, dtype, m.stride,
                                                           m.in_channels)]
    assert len(taken) == want
    assert all(m.stride == (1, 1) for m in taken)
    strided = [m for m in three if m.stride == (2, 2)]
    assert len(strided) == 4
    assert not any(c3.kernel_takes("cuda", torch.float32, m.stride, m.in_channels)
                   for m in strided)


@pytest.mark.parametrize("stride,ci,want", [(1, 64, True), ((1, 1), 512, True),
                                            (2, 64, False), ((2, 2), 512, False),
                                            (1, 3, False), (1, 6, False),
                                            (1, 4, True)])
def test_kernel_takes_is_a_function_of_stride_and_channels(stride, ci, want):
    assert c3.kernel_takes(torch.device("cuda"), torch.float32, stride, ci) is want
    assert not c3.kernel_takes(torch.device("cpu"), torch.float32, stride, ci)


def _as_plain_conv2d(model):
    """A copy of ``model`` with every Conv3x3 replaced by the ``nn.Conv2d``
    it stands for, carrying the same weight."""
    for name, child in list(model.named_children()):
        if isinstance(child, Conv3x3):
            plain = nn.Conv2d(child.in_channels, child.out_channels, 3,
                              child.stride, 1, bias=False)
            plain.weight = nn.Parameter(child.weight.detach().clone())
            setattr(model, name, plain)
        else:
            _as_plain_conv2d(child)
    return model


@pytest.mark.parametrize("size", [32, 48])
def test_encoder_cpu_output_and_keys_are_the_conv2d_trunks(size):
    """FSEncoderPSP (one unit per stage, the published widths) on the CPU
    gives bit for bit what its nn.Conv2d trunk gives, and has that trunk's
    state_dict keys (``res_layer.1.weight``, ``res_layer.3.weight`` per
    unit)."""
    enc = init_module_(FSEncoderPSP(slim=True), torch.Generator().manual_seed(3))
    enc.eval()
    ref = _as_plain_conv2d(init_module_(FSEncoderPSP(slim=True),
                                        torch.Generator().manual_seed(3)))
    ref.load_state_dict(enc.state_dict())
    assert list(enc.state_dict()) == list(ref.state_dict())
    keys = set(enc.state_dict())
    for i in range(len(enc.body)):
        assert {f"body.{i}.res_layer.1.weight", f"body.{i}.res_layer.3.weight"} <= keys
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, size, size), generator=g)
    seg = F.one_hot(torch.randint(0, 12, (2, size, size), generator=g), 12)
    seg = seg.permute(0, 3, 1, 2).float()
    with torch.no_grad():
        codes, feats = enc(x, seg)
        want_codes, want_feats = ref(x, seg)
    assert torch.equal(codes, want_codes)
    assert torch.equal(feats, want_feats) and feats.is_contiguous()


def test_irse50_backbone_keeps_its_keys():
    with torch.device("meta"):
        keys = list(IRSE50Backbone().state_dict())
    assert "body.0.res_layer.1.weight" in keys and "body.23.res_layer.3.weight" in keys
    assert not any("_packed" in k for k in keys)


def test_instance_norm_keeps_channels_last():
    """A channels-last input: the same mean and biased variance over (H, W)
    as ``F.instance_norm``, and the output stays channels-last; an NCHW
    input takes ``F.instance_norm`` itself."""
    g = torch.Generator().manual_seed(5)
    x = 3 + 2 * torch.randn((2, 16, 9, 7), generator=g)
    norm = InstanceNorm()
    want = F.instance_norm(x, eps=1e-5)
    assert torch.equal(norm(x), want)
    got = norm(x.contiguous(memory_format=torch.channels_last))
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_unit_forward_is_layout_blind_on_the_cpu():
    """A unit on a channels-last input gives the NCHW input's values."""
    unit = init_module_(BottleneckIRSE(8, 16, 1), torch.Generator().manual_seed(6))
    x = torch.randn((2, 8, 6, 6), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = unit(x)
        got = unit(x.contiguous(memory_format=torch.channels_last))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B", [1, 2, 16])
@pytest.mark.parametrize("H,Ci,Co", [(256, 64, 128), (128, 128, 128), (64, 256, 512),
                                     (32, 512, 512), (16, 512, 512), (5, 24, 40)])
def test_plan_fills_the_card_and_keeps_whole_steps(B, H, Ci, Co):
    th, tw, splits = c3.plan(B, H, H, Ci, Co, sms=132)
    assert (th, tw) in c3.TILES
    blocks = B * -(-H // th) * -(-H // tw) * -(-Co // 128)
    steps = -(-Ci // c3.TILE_K)
    assert splits == 1 or (blocks * splits <= 132 and steps >= 4 * splits)
    assert splits & (splits - 1) == 0


def test_launch_checks_its_inputs():
    x = torch.randn((1, 4, 4, 8))
    w = torch.randn((16, 8, 3, 3))
    with pytest.raises(TypeError):
        c3._launch(x.double(), w)
    with pytest.raises(TypeError):
        c3._launch(x, w.double())
    with pytest.raises(ValueError):
        c3._launch(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        c3._launch(x, torch.randn((16, 4, 3, 3)))
    with pytest.raises(ValueError):
        c3._launch(torch.randn((1, 4, 4, 6)), torch.randn((16, 6, 3, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        c3._launch(x, w)


def test_function_backward_is_the_plain_versions(monkeypatch):
    """``kernel_lib.PlainGrad``'s backward differentiates the plain version:
    with the launch replaced by the plain version, the gradients w.r.t. x
    and w are ``F.conv2d``'s."""
    monkeypatch.setattr(c3, "_launch", lambda x, w, packed=None: c3.conv3x3_nhwc_plain(x, w))
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 6, 5, 8), generator=g, requires_grad=True)
    w = torch.randn((12, 8, 3, 3), generator=g, requires_grad=True)
    r = torch.randn((2, 6, 5, 12), generator=g)
    got = torch.autograd.grad(
        (with_plain_grad(c3._launch, c3.conv3x3_nhwc_plain, (x, w), None) * r).sum(), (x, w))
    want = torch.autograd.grad(
        (F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1) * r).sum(),
        (x, w))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    (gx,) = torch.autograd.grad(
        (with_plain_grad(c3._launch, c3.conv3x3_nhwc_plain, (x, w.detach()), None) * r).sum(),
        (x,))
    torch.testing.assert_close(gx, want[0])


def test_conv3x3_module_caches_its_packed_weight():
    """The packed weight is built once and rebuilt after an in-place change
    of the weight; where the weight takes a gradient, per call."""
    conv = Conv3x3(8, 16)
    conv.weight.requires_grad_(False)

    def packed():
        return cached(conv, (conv.weight,), lambda: pack_weight(conv.weight))

    a = packed()
    assert packed() is a is conv._kernel_cache.value
    with torch.no_grad():
        conv.weight.mul_(2)
    b = packed()
    assert b is not a
    torch.testing.assert_close(b, 2 * a)
    conv.weight.requires_grad_(True)
    assert packed() is not packed()
