"""Ops of the PyTorch port (e4s_tpu_torch.ops) against the JAX package on the
same seeded inputs, f32 on the CPU, where every kernel wrapper takes its
plain version. Tolerance: 1e-4 of the reference's max |value| for ops, and
1e-5 (rtol and atol) for the plain patch-modulated conv, as the JAX
package's own Pallas tests hold its kernel."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import rel_err, torch_threads

from e4s_tpu.ops import modconv as jmc
from e4s_tpu.ops import morphology as jmorph
from e4s_tpu.ops import resize as jresize
from e4s_tpu.ops.masked_pool import masked_region_mean as j_region_mean
from e4s_tpu.ops.upfirdn2d import blur as j_blur
from e4s_tpu.ops.upfirdn2d import make_kernel as j_make_kernel
from e4s_tpu.ops.upfirdn2d import upfirdn2d as j_upfirdn2d
from e4s_tpu.ops.upfirdn2d import upsample2 as j_upsample2
from e4s_tpu.ops.pallas.modconv_tpu import patch_mod_conv3_nhwc as j_pallas

from e4s_tpu_torch.models.stylegan2 import ModulatedConv2d
from e4s_tpu_torch.ops import modconv as tmc
from e4s_tpu_torch.ops import morphology as tmorph
from e4s_tpu_torch.ops import patch_modconv as tpmc
from e4s_tpu_torch.ops import resize as tresize
from e4s_tpu_torch.ops import upfirdn2d as tfir
from e4s_tpu_torch.ops.masked_pool import masked_region_mean as t_region_mean

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    with torch_threads(2):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _onehot(rng, B, R, S):
    lab = rng.randint(0, R, (B, S, S))
    lab[:, : S // 4] = 0  # an empty region or two, and a large one
    return (lab[:, None] == np.arange(R)[None, :, None, None]).astype(np.float32)


# ---------------------------------------------------------------- kernel twin


@pytest.mark.parametrize(
    "B,Ci,Co,H,W", [(1, 32, 32, 16, 256), (1, 16, 48, 8, 128), (2, 16, 32, 5, 7)]
)
def test_patch_mod_conv3_plain_matches_xla(B, Ci, Co, H, W):
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, Ci).astype(np.float32)
    w = (rng.randn(Co, Ci, 3, 3) * 0.05).astype(np.float32)
    smap = rng.randn(B, H, W, Ci).astype(np.float32)
    dmap = rng.randn(B, H, W, Co).astype(np.float32)
    want = np.asarray(jmc._patch_mod_conv_nhwc_xla(x, w, smap, dmap))
    got = tpmc.patch_mod_conv3_nhwc(_t(x), _t(w), _t(smap), _t(dmap)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tpmc.patch_mod_conv3_nhwc.launches == 0  # CPU: no kernel launch


@pytest.mark.parametrize("Ci,Co,H,W", [(32, 32, 16, 256), (16, 32, 8, 128)])
def test_patch_mod_conv3_plain_matches_pallas_interpret(Ci, Co, H, W):
    rng = np.random.RandomState(1)
    x = rng.randn(1, H, W, Ci).astype(np.float32)
    w = (rng.randn(Co, Ci, 3, 3) * 0.05).astype(np.float32)
    smap = rng.randn(1, H, W, Ci).astype(np.float32)
    dmap = rng.randn(1, H, W, Co).astype(np.float32)
    want = np.asarray(j_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(smap),
                               jnp.asarray(dmap), interpret=True))
    got = tpmc.patch_mod_conv3_nhwc_plain(_t(x), _t(w), _t(smap), _t(dmap))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_patch_mod_conv3_autograd_routes_through_plain(monkeypatch):
    """The autograd.Function's backward differentiates the plain version
    (the kernel launch itself is stood in for by the plain forward here)."""
    monkeypatch.setattr(
        tpmc, "_launch",
        lambda x, w, smap, dmap, packed, up: tpmc.patch_mod_conv3_nhwc_plain(
            x, w, smap, dmap))
    rng = np.random.RandomState(2)
    ins = [rng.randn(*s).astype(np.float32)
           for s in ((1, 6, 5, 4), (8, 4, 3, 3), (1, 6, 5, 4), (1, 6, 5, 8))]
    a = [_t(v).requires_grad_() for v in ins]
    b = [_t(v).requires_grad_() for v in ins]
    torch.sin(tpmc._PatchModConv3.apply(*a)).sum().backward()
    torch.sin(tpmc.patch_mod_conv3_nhwc_plain(*b)).sum().backward()
    for ga, gb in zip(a, b):
        torch.testing.assert_close(ga.grad, gb.grad, rtol=1e-6, atol=1e-6)


def test_patch_mod_conv3_wrapper_checks_inputs():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        tpmc._launch(x, torch.zeros(16, 8, 3, 3), torch.zeros(1, 4, 4, 4), None)
    with pytest.raises(TypeError):
        tpmc._launch(x.double(), torch.zeros(16, 8, 3, 3),
                     torch.zeros(1, 4, 4, 8).double(), None)


def _up_case(rng, B, R, Ci, Co, H, W):
    x = rng.randn(B, Ci, H, W).astype(np.float32)
    w = (rng.randn(Co, Ci, 3, 3) / np.sqrt(Ci * 9)).astype(np.float32)
    s = (1 + 0.3 * rng.randn(B, R, Ci)).astype(np.float32)
    return x, w, s, _onehot(rng, B, R, 16)


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


@pytest.mark.parametrize("Ci,Co,H,W", [(32, 16, 5, 7), (16, 32, 8, 8)])
def test_patch_mod_conv3_up_plain_matches_jax(Ci, Co, H, W):
    """The fused up entry's plain version (4 stride-1 plain calls +
    interleave) on the JAX package's own phase kernels and region maps
    equals its masked up-conv, and so does the port's layer."""
    rng = np.random.RandomState(12)
    x, w, s, mask = _up_case(rng, 1, 12, Ci, Co, H, W)
    want = np.asarray(jmc.masked_modulated_conv2d(x, w, s, mask, up=True))
    E = np.asarray(jmc._composite_up_kernel(w, np.asarray(j_make_kernel((1, 3, 3, 1))) * 4.0))
    wp = np.stack([E[:, :, (a + 4, a + 2, a)][:, :, :, (b + 4, b + 2, b)]
                   for a in (0, 1) for b in (0, 1)])
    d = jmc.demod_coeff(w, s)
    smap, dmap = jmc._region_maps(mask, s, d, (2 * H, 2 * W), jnp.float32)
    got = tpmc.patch_mod_conv3_up_nhwc(
        _t(_nhwc(x)), _t(wp), _t(_nhwc(smap)), _t(_nhwc(dmap)))
    assert got.shape == (1, 2 * H, 2 * W, Co)
    assert rel_err(got, _nhwc(want)) < TOL
    layer = tmc.masked_modulated_conv2d(_t(x), _t(w), _t(s), _t(mask), up=True)
    assert rel_err(layer, want) < TOL
    assert tpmc.patch_mod_conv3_nhwc.launches == 0  # CPU: no kernel launch


def test_patch_mod_conv3_up_autograd_routes_through_plain(monkeypatch):
    monkeypatch.setattr(
        tpmc, "_launch",
        lambda x, w, smap, dmap, packed, up: tpmc.patch_mod_conv3_up_nhwc_plain(
            x, w, smap, dmap))
    rng = np.random.RandomState(13)
    ins = [rng.randn(*s).astype(np.float32) for s in (
        (1, 3, 4, 4), (4, 8, 4, 3, 3), (1, 6, 8, 4), (1, 6, 8, 8))]
    a = [_t(v).requires_grad_() for v in ins]
    b = [_t(v).requires_grad_() for v in ins]
    torch.sin(tpmc._PatchModConv3.apply(*a, None, True)).sum().backward()
    torch.sin(tpmc.patch_mod_conv3_up_nhwc_plain(*b)).sum().backward()
    for ga, gb in zip(a, b):
        torch.testing.assert_close(ga.grad, gb.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("up", [False, True])
def test_pack_weight_tiles_hold_the_tf32_split(up):
    """Each (K step, 128-channel block) tile holds tap t's [n, k] entry at
    the core-matrix offset the kernel's wgmma descriptors read, as a TF32
    high half plus a TF32 low half; padding past Co and Ci is zero."""
    rng = np.random.RandomState(14)
    Co, Ci = 136, 20
    w = torch.from_numpy(rng.randn(*((4,) if up else ()), Co, Ci, 3, 3).astype(np.float32))
    packed = tpmc.pack_weight(w)
    P = 4 if up else 1
    assert tuple(packed.shape) == tpmc.packed_shape(P, Co, Ci)
    tiles = packed.reshape(P, 3, 2, 2, 9, 1024)
    assert (tiles.view(torch.int32) & 0x1FFF).eq(0).all()  # TF32 values
    wp = w.reshape(P, Co, Ci, 9)
    for _ in range(300):
        ph, o, i, tap = (rng.randint(n) for n in (P, Co, Ci, 9))
        (step, k), (blk, n) = divmod(i, 8), divmod(o, 128)
        j = (n >> 3) * 64 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3)
        hi, lo = tiles[ph, step, blk, :, tap, j]
        assert abs(float(hi + lo) - float(wp[ph, o, i, tap])) <= 2e-7 * abs(float(wp[ph, o, i, tap]))
    assert tiles[:, 2, :, :, :].reshape(-1, 1024)[:, 32:64].eq(0).all()  # k>=20
    assert tiles[:, :, 1, :, :, 64:].eq(0).all()  # o >= 136


@pytest.mark.parametrize("B,H,W,Ci,Co,P,splits", [
    (1, 4, 4, 512, 512, 1, 32), (1, 4, 4, 512, 512, 4, 8),
    (1, 16, 16, 512, 512, 1, 16), (1, 32, 32, 512, 512, 4, 1),
    (1, 64, 64, 512, 512, 1, 2), (1, 256, 256, 128, 128, 1, 1),
    (1, 3, 5, 200, 136, 1, 8),
])
def test_plan_splits_k_to_fill_the_card(B, H, W, Ci, Co, P, splits):
    """Small layers split K until the grid fills 132 SMs in one wave; every
    split keeps at least 2 K steps."""
    th, tw, got = tpmc.plan(B, H, W, Ci, Co, P)
    assert got == splits
    blocks = B * P * -(-H // th) * -(-W // tw) * -(-Co // 128)
    assert blocks * got <= max(132, blocks)
    assert -(-Ci // 8) >= 2 * got or got == 1


def test_modulated_conv_weights_cache_rebuilds_after_load_state_dict():
    """The kernel's weights (phase kernels and packed layout) are built once
    per weight and rebuilt after an in-place update of the weight; where
    the weight takes a gradient they are built per call."""
    g = torch.Generator().manual_seed(0)
    conv = ModulatedConv2d(8, 16, 3, 16, upsample=True)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    rng = np.random.RandomState(15)
    x = _t(rng.randn(1, 8, 4, 4).astype(np.float32))
    style = _t(rng.randn(1, 12, 16).astype(np.float32))
    mask = _t(_onehot(rng, 1, 12, 8))
    with torch.no_grad():
        out0 = conv(x, style, mask)
        cached = conv._kernel_weights
        conv(x, style, mask)
        assert conv._kernel_weights is cached
        state = {k: v.clone() for k, v in conv.state_dict().items()}
        state["weight"] = torch.randn(state["weight"].shape, generator=g)
        conv.load_state_dict(state)
        out1 = conv(x, style, mask)
        assert conv._kernel_weights is not cached
        fresh = tmc.masked_conv_weights(
            conv.weight[0] * conv.scale, up=True, blur_kernel=conv.blur_kernel)
        torch.testing.assert_close(conv._kernel_weights[0], fresh[0])
    assert not torch.allclose(out0, out1)
    conv(x, style, mask).sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.abs().sum() > 0


# ------------------------------------------------------------- masked convs


@pytest.mark.parametrize("up", [False, True])
def test_masked_modulated_conv2d_matches_jax_and_naive(up):
    rng = np.random.RandomState(3)
    B, R, Ci, Co, H = 2, 12, 8, 16, 8
    x = rng.randn(B, Ci, H, H).astype(np.float32)
    w = (rng.randn(Co, Ci, 3, 3) / np.sqrt(Ci * 9)).astype(np.float32)
    s = (1 + 0.3 * rng.randn(B, R, Ci)).astype(np.float32)
    mask = _onehot(rng, B, R, 32)
    want = np.asarray(jmc.masked_modulated_conv2d(x, w, s, mask, up=up))
    got = tmc.masked_modulated_conv2d(_t(x), _t(w), _t(s), _t(mask), up=up)
    naive = tmc.masked_modulated_conv2d_naive(_t(x), _t(w), _t(s), _t(mask), up=up)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert rel_err(got, want) < TOL
    assert rel_err(got, naive) < TOL


def test_modulated_conv2d_up_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 6, 6).astype(np.float32)
    w = (rng.randn(4, 8, 3, 3) / 8).astype(np.float32)
    s = (1 + 0.3 * rng.randn(2, 8)).astype(np.float32)
    for up in (False, True):
        want = np.asarray(jmc.modulated_conv2d(x, w, s, up=up))
        got = tmc.modulated_conv2d(_t(x), _t(w), _t(s), up=up)
        assert rel_err(got, want) < TOL


def test_masked_torgb_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    w = rng.randn(3, 8, 1, 1).astype(np.float32)
    s = rng.randn(2, 12, 8).astype(np.float32)
    mask = _onehot(rng, 2, 12, 16)
    want = np.asarray(jmc.masked_torgb(x, w, s, mask))
    assert rel_err(tmc.masked_torgb(_t(x), _t(w), _t(s), _t(mask)), want) < TOL


def test_composite_up_kernel_matches_jax():
    rng = np.random.RandomState(6)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    bk = np.asarray(j_make_kernel((1, 3, 3, 1))) * 4.0
    want = np.asarray(jmc._composite_up_kernel(w, bk))
    got = tmc._composite_up_kernel(_t(w), tfir.make_kernel((1, 3, 3, 1)) * 4.0)
    assert rel_err(got, want) < 1e-6


# ------------------------------------------------------------ resampling


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 2)), (2, 1, (2, 1)),
                                         (1, 2, (1, 1)), (1, 1, (-1, 0))])
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 9, 9).astype(np.float32)
    k = np.asarray(j_make_kernel((1, 3, 3, 1)))
    want = np.asarray(j_upfirdn2d(x, k, up=up, down=down, pad=pad))
    got = tfir.upfirdn2d(_t(x), _t(k), up=up, down=down, pad=pad)
    assert got.shape == want.shape
    assert rel_err(got, want) < TOL


def test_upsample2_and_blur_match_jax():
    rng = np.random.RandomState(8)
    x = rng.randn(1, 3, 8, 8).astype(np.float32)
    want = np.asarray(j_upsample2(x))
    assert rel_err(tfir.upsample2(_t(x)), want) < TOL
    assert rel_err(tfir.upsample2(_t(x), tfir.make_kernel((1, 3, 3, 1)) * 4), want) < TOL
    want = np.asarray(j_blur(x, (1, 3, 3, 1), pad=(2, 1), upsample_factor=2))
    assert rel_err(tfir.blur(_t(x), (1, 3, 3, 1), (2, 1), 2), want) < TOL


@pytest.mark.parametrize("size", [(4, 4), (12, 20), (32, 48)])
def test_resizes_match_jax(size):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 16, 24).astype(np.float32)
    got = tresize.nearest_resize(_t(x), size).numpy()
    np.testing.assert_array_equal(got, np.asarray(jresize.nearest_resize(x, size)))
    for ac in (False, True):
        want = np.asarray(jresize.bilinear_resize(x, size, align_corners=ac))
        assert rel_err(tresize.bilinear_resize(_t(x), size, ac), want) < TOL
    want = np.asarray(jresize.adaptive_avg_pool2d(x, (4, 4)))
    assert rel_err(tresize.adaptive_avg_pool2d(_t(x), (4, 4)), want) < TOL


def test_masked_region_mean_matches_jax_and_empty_is_zero():
    rng = np.random.RandomState(10)
    feats = rng.randn(2, 16, 8, 8).astype(np.float32)
    seg = _onehot(rng, 2, 12, 32)
    seg[:, 5] = 0  # region 5 empty (its pixels go to 0)
    seg[:, 0] = np.maximum(seg[:, 0], (seg.sum(1) == 0))
    want = np.asarray(j_region_mean(feats, seg))
    got = t_region_mean(_t(feats), _t(seg))
    assert rel_err(got, want) < TOL
    assert (got[:, 5] == 0).all()


@pytest.mark.parametrize("op", ["dilation", "erosion", "expansion"])
def test_create_masks_matches_jax(op):
    rng = np.random.RandomState(11)
    m = (rng.rand(2, 1, 24, 24) > 0.6).astype(np.float32)
    want = jmorph.create_masks(m, outer_dilation=2, operation=op)
    got = tmorph.create_masks(_t(m), outer_dilation=2, operation=op)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- the package


def test_port_imports_no_jax_and_nothing_of_e4s_tpu():
    """Read every module's imports: the port stands alone (torch, numpy,
    PIL), and so do its GPU scripts."""
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "e4s_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py", root / "scripts" / "profile_torch_swap.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "e4s_tpu")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in banned, f"{f.name} imports {n}"
