"""RealESRNet's NHWC path (``models/gpen/rrdbnet.py::RRDBNet.forward_nhwc``)
and the plain version of its 32-channel conv (``ops/conv3x3_n32.py``) on the
CPU, at sizes that take well under a second. The kernel itself is held to the
plain version on the card (``tests/test_torch_cuda.py``)."""

import copy
import json
import os
import pickle

import pytest
import torch
import torch.nn.functional as F

from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet
from e4s_tpu_torch.ops import conv3x3_n32 as n32

KEYMAP = os.path.join(os.path.dirname(__file__), "fixtures", "torch_keymaps",
                      "gpen_realesrnet.json")


def _net(scale, seed=0):
    torch.manual_seed(seed)
    return RRDBNet(scale=scale, num_block=2).eval()


@pytest.mark.parametrize("scale", [4, 2, 1])
def test_nhwc_table_equals_the_module_forward(scale):
    """The table of steps run by the plain version (the CPU's route for the
    kernel path) against the modules as written: a 2-block net at 16^2."""
    net = _net(scale)
    x = torch.rand((2, 3, 16, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net(x)
        unshuffled = {4: x, 2: F.pixel_unshuffle(x, 2), 1: F.pixel_unshuffle(x, 4)}[scale]
        got = net.forward_nhwc(unshuffled)
    assert got.shape == want.shape == (2, 3, 16 * scale, 16 * scale)
    assert got.is_contiguous()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_table_is_349_steps_over_7_buffers():
    """RealESRNet x4 (23 blocks): 345 trunk convs, conv_body, the up path;
    each dense block's conv k reads 32k channels and writes the next 32."""
    with torch.device("meta"):
        net = RRDBNet(scale=4)
    steps = net._steps()
    assert len(steps) == len(net._convs()) == 349
    assert [s.ci for s in steps[:5]] == [32, 64, 96, 128, 160]
    assert [s.oc for s in steps[:4]] == [32, 64, 96, 128]
    assert all(c.weight.shape[1] == s.ci for c, s in zip(net._convs(), steps))
    assert {i for s in steps for i in (s.x, s.out, s.r1, s.r2) if i is not None} == set(range(7))


def test_kernel_route_is_a_function_of_device_dtype_grad_and_ci(monkeypatch):
    """The kernel path is taken on a CUDA float32 input with grad mode off
    and Ci a multiple of 4, and nowhere else; a CPU forward never takes it."""
    takes = n32.kernel_takes
    assert takes("cuda", torch.float32, False, 32)
    assert takes(torch.device("cuda", 1), torch.float32, False, 12)
    assert not takes("cpu", torch.float32, False, 32)
    assert not takes("cuda", torch.bfloat16, False, 32)
    assert not takes("cuda", torch.float16, False, 32)
    assert not takes("cuda", torch.float32, True, 32)
    assert not takes("cuda", torch.float32, False, 30)
    calls = []
    monkeypatch.setattr(RRDBNet, "forward_nhwc", lambda self, x: calls.append(x))
    net = _net(4)
    x = torch.rand((1, 3, 8, 8))
    net(x)
    with torch.no_grad():
        net(x)
        net.to(torch.bfloat16)(x.bfloat16())
    assert calls == []


def test_state_dict_keys_unchanged_and_tables_not_copied():
    """The reference checkpoint's keys, before and after the NHWC path has
    kept its tables; a deep copy (the chain's bf16 copy) or a pickle keeps
    the step table and drops the packed tables."""
    with open(KEYMAP) as f:
        keymap = json.load(f)
    with torch.device("meta"):  # shapes alone: the full net, nothing drawn
        net = RRDBNet(scale=2)
    net.requires_grad_(False)
    before = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    _, steps, packed = net._table(torch.device("cuda"))  # what the card's path keeps
    assert len(steps) == 349 and packed.wpack.device.type == "meta"
    assert net._table(torch.device("cuda"))[2] is packed is net._kernel_cache.value
    after = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert before == after == {k: tuple(v) for k, v in keymap.items()}
    for twin in (copy.deepcopy(net), pickle.loads(pickle.dumps(net))):
        assert twin._kernel_cache.value is None
        convs, twin_steps = twin._kernel
        assert twin_steps == steps and convs[0] is twin.body[0].rdb1.conv1


def test_plain_conv_reads_a_channel_prefix_and_writes_at_an_offset():
    """``conv3x3_n32`` on the CPU: channels [0, 40) of a 64-channel buffer
    through a 2x upsample, written at channel 16 of a 48-channel buffer,
    with LeakyReLU and two residuals; the other channels untouched."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 6, 64), generator=g)
    w = torch.randn((32, 40, 3, 3), generator=g)
    b = torch.randn((32,), generator=g)
    out = torch.randn((2, 10, 12, 48), generator=g)
    r1 = torch.randn((2, 10, 12, 36), generator=g)
    r2 = out.clone()
    keep = out.clone()
    got = n32.conv3x3_n32(x, w, b, ci=40, out=out, oc=16, up=True, lrelu=True,
                          r1=r1, a1=0.2, r2=r2, a2=0.5)
    assert got is out
    xu = x[..., :40].permute(0, 3, 1, 2).repeat_interleave(2, 2).repeat_interleave(2, 3)
    y = F.leaky_relu(F.conv2d(xu, w, b, padding=1), 0.2).permute(0, 2, 3, 1)
    want = (y * 0.2 + r1[..., :32]) * 0.5 + r2[..., :32]
    assert torch.equal(out[..., :16], keep[..., :16])
    assert torch.equal(out[..., 48:], keep[..., 48:])
    assert (out[..., 16:48] - want).abs().max() <= 1e-5 * want.abs().max()


def test_pack_weight_layout():
    """[Ci, tap row, tap column, 32], Ci zero-padded to a whole stage of 8."""
    w = torch.randn((32, 12, 3, 3), generator=torch.Generator().manual_seed(4))
    p = n32.pack_weight(w)
    assert p.shape == (16, 3, 3, 32) and p.is_contiguous()
    assert torch.equal(p[:12], w.permute(1, 2, 3, 0))
    assert not p[12:].any()
