"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips when no GPU is present
(decided inside the test). On a GPU machine (``--noconftest``: the suite's
conftest imports JAX, which a GPU machine for the port need not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| in f32 with TF32 off;
the sums run over up to 9 * 512 terms in another order. In bf16 8e-3 *
max |plain|: both sum in f32 and round once, so a result may land on the
neighbouring bf16 value (one ulp is 2^-8 of the value).
"""

import ctypes
import math
import types

import numpy as np
import pytest
import torch

from e4s_tpu_torch.models.stylegan2 import ModulatedConv2d
from e4s_tpu_torch.ops import patch_modconv as pmc
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

# (input H=W, Ci, Co) of every patch-modulated conv on the 1024^2 main path;
# 4^2-32^2 split K over Ci
MAIN_PATH_SHAPES = [
    (4, 512, 512), (8, 512, 512), (16, 512, 512), (32, 512, 512),
    (64, 512, 512), (64, 512, 256), (128, 256, 256), (128, 256, 128),
    (256, 128, 128),
]
# (input H=W, Ci, Co) of the six masked up-convs (one fused launch each)
UP_SHAPES = [
    (4, 512, 512), (8, 512, 512), (16, 512, 512), (32, 512, 512),
    (64, 512, 256), (128, 256, 128),
]
# (B, H, W, Ci, Co): tiles that overhang H, W, Ci and Co (8x8, 8x16 and
# 16x16 pixel tiles); (1, 3, 5, 200, 136) plans split K with an empty last
# split
RAGGED = [(2, 5, 7, 24, 40), (1, 9, 130, 16, 8), (1, 3, 5, 200, 136),
          (1, 70, 60, 20, 136)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _inputs(H, Ci, Co, dev, B=1, W=None, up=False):
    """x [B,H,W,Ci]; w [Co,Ci,3,3] or, for ``up``, 4 phase weights
    [4,Co,Ci,3,3]; smap, dmap at the output resolution (2x for ``up``)."""
    g = torch.Generator(device=dev).manual_seed(H * 1000 + Ci + Co)
    W = W or H
    s = 2 if up else 1
    x = torch.randn((B, H, W, Ci), generator=g, device=dev)
    w = torch.randn(((4,) if up else ()) + (Co, Ci, 3, 3), generator=g,
                    device=dev) / math.sqrt(9 * Ci)
    smap = 1 + 0.5 * torch.randn((B, s * H, s * W, Ci), generator=g, device=dev)
    dmap = 0.5 + torch.rand((B, s * H, s * W, Co), generator=g, device=dev)
    return x, w, smap, dmap


def _check(got, want, tol=1e-4):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("H,Ci,Co", MAIN_PATH_SHAPES)
def test_patch_mod_conv3_kernel_matches_plain(card, H, Ci, Co):
    x, w, smap, dmap = _inputs(H, Ci, Co, card)
    before = pmc.patch_mod_conv3_nhwc.launches
    got = pmc.patch_mod_conv3_nhwc(x, w, smap, dmap)
    assert pmc.patch_mod_conv3_nhwc.launches == before + 1
    _check(got, pmc.patch_mod_conv3_nhwc_plain(x, w, smap, dmap))


@pytest.mark.cuda
@pytest.mark.parametrize("H,Ci,Co", MAIN_PATH_SHAPES)
def test_patch_mod_conv3_kernel_matches_plain_at_batch_8(card, H, Ci, Co):
    """``swap_batch``'s chunk of 8: the split-K plan takes fewer splits."""
    x, w, smap, dmap = _inputs(H, Ci, Co, card, B=8)
    _check(pmc.patch_mod_conv3_nhwc(x, w, smap, dmap),
           pmc.patch_mod_conv3_nhwc_plain(x, w, smap, dmap))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Ci,Co", RAGGED)
def test_patch_mod_conv3_kernel_ragged_edges(card, B, H, W, Ci, Co):
    """Tiles that overhang H, W, Ci and Co; no dmap."""
    x, w, smap, _ = _inputs(H, Ci, Co, card, B=B, W=W)
    got = pmc.patch_mod_conv3_nhwc(x, w, smap, None)
    _check(got, pmc.patch_mod_conv3_nhwc_plain(x, w, smap, None))


@pytest.mark.cuda
@pytest.mark.parametrize("H,Ci,Co", UP_SHAPES)
def test_patch_mod_conv3_up_kernel_matches_plain(card, H, Ci, Co):
    """One launch per masked up-conv, against 4 plain calls + interleave."""
    x, wp, smap, dmap = _inputs(H, Ci, Co, card, up=True)
    before = pmc.patch_mod_conv3_nhwc.launches
    got = pmc.patch_mod_conv3_up_nhwc(x, wp, smap, dmap)
    assert pmc.patch_mod_conv3_nhwc.launches == before + 1
    assert got.shape == (1, 2 * H, 2 * H, Co)
    _check(got, pmc.patch_mod_conv3_up_nhwc_plain(x, wp, smap, dmap))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Ci,Co", RAGGED)
def test_patch_mod_conv3_up_kernel_ragged_edges(card, B, H, W, Ci, Co):
    x, wp, smap, _ = _inputs(H, Ci, Co, card, B=B, W=W, up=True)
    got = pmc.patch_mod_conv3_up_nhwc(x, wp, smap, None)
    _check(got, pmc.patch_mod_conv3_up_nhwc_plain(x, wp, smap, None))


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("H,Ci,Co", [(4, 512, 512), (64, 512, 256)])
def test_patch_mod_conv3_kernel_repeats_bitwise(card, H, Ci, Co, up):
    """Split K sums in a fixed order (no atomics): two launches agree bit
    for bit, with and without splits."""
    x, w, smap, dmap = _inputs(H, Ci, Co, card, up=up)
    fn = pmc.patch_mod_conv3_up_nhwc if up else pmc.patch_mod_conv3_nhwc
    a = fn(x, w, smap, dmap)
    b = fn(x, w, smap, dmap)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_patch_mod_conv3_kernel_rejects_bad_inputs(card):
    x, w, smap, dmap = _inputs(8, 16, 16, card)
    with pytest.raises(ValueError):
        pmc.patch_mod_conv3_nhwc(x.transpose(1, 2), w, smap, dmap)
    with pytest.raises(TypeError):
        pmc.patch_mod_conv3_nhwc(x.double(), w, smap.double(), dmap)


@pytest.mark.cuda
def test_swap_on_the_card_matches_the_cpu(card):
    """A small seeded swapper (64^2, K=7: 4 stride-1 + 3 up masked convs,
    one launch each) on the card and on the CPU, where the kernel's plain
    version runs instead."""
    opts = types.SimpleNamespace(
        num_seg_cls=12, out_size=64, remaining_layer_idx=7, n_styles=10,
        start_from_latent_avg=True, encoder_size=64, parser_size=64,
    )
    rng = np.random.RandomState(0)
    src, tgt = (np.kron(rng.uniform(0, 1, (1, 3, 8, 8)), np.ones((8, 8)))
                for _ in range(2))
    out = {}
    for dev in ("cuda", "cpu"):
        swapper = FaceSwapper(opts, device=dev, seed=2)
        pmc.patch_mod_conv3_nhwc.launches = 0
        out[dev] = np.asarray(swapper.swap_from_arrays(src, tgt), np.float64)
        assert pmc.patch_mod_conv3_nhwc.launches == (7 if dev == "cuda" else 0)
    mse = np.mean((out["cuda"] - out["cpu"]) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 40.0


@pytest.mark.cuda
def test_segnext_lap_bld_and_staged_paths_on_the_card_match_the_cpu(card):
    """SegNeXt-tiny + lap_bld at 64^2 (K=7: 7 launches per request), fused
    and staged with the CPU's own target parse as the mask."""
    opts = types.SimpleNamespace(
        num_seg_cls=12, out_size=64, remaining_layer_idx=7, n_styles=10,
        start_from_latent_avg=True, encoder_size=64, parser_size=64,
        faceParser_name="segnext", segnext_variant="tiny", lap_bld=True,
    )
    rng = np.random.RandomState(1)
    src, tgt = (np.kron(rng.uniform(0, 1, (1, 3, 8, 8)), np.ones((8, 8)))
                for _ in range(2))
    out, mask = {}, None
    for dev in ("cpu", "cuda"):
        swapper = FaceSwapper(opts, device=dev, seed=3)
        if mask is None:
            mask = swapper._parse12(tgt)[0]
        pmc.patch_mod_conv3_nhwc.launches = 0
        out[dev] = [np.asarray(swapper.swap_from_arrays(src, tgt), np.float64),
                    np.asarray(swapper.swap_from_arrays(src, tgt, target_mask=mask),
                               np.float64)]
        assert pmc.patch_mod_conv3_nhwc.launches == (14 if dev == "cuda" else 0)
    for a, b in zip(out["cuda"], out["cpu"]):
        mse = np.mean((a - b) ** 2)
        assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 40.0


# the 13 main-path launches: (input H=W, Ci, Co, up)
STAGES = [(H, Ci, Co, False) for H, Ci, Co in MAIN_PATH_SHAPES
          if (H, Ci, Co) not in ((64, 512, 256), (128, 256, 128))] + [
    (H, Ci, Co, True) for H, Ci, Co in UP_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("H,Ci,Co,up", STAGES)
def test_patch_mod_conv3_bf16_kernel_matches_plain(card, H, Ci, Co, up, B):
    """The bf16 instantiation at every main-path stage, B = 1 and 8."""
    x, w, smap, dmap = (t.bfloat16() for t in _inputs(H, Ci, Co, card, B=B, up=up))
    fn, plain = ((pmc.patch_mod_conv3_up_nhwc, pmc.patch_mod_conv3_up_nhwc_plain)
                 if up else (pmc.patch_mod_conv3_nhwc, pmc.patch_mod_conv3_nhwc_plain))
    before = pmc.patch_mod_conv3_nhwc.launches
    got = fn(x, w, smap, dmap)
    assert pmc.patch_mod_conv3_nhwc.launches == before + 1
    assert got.dtype == torch.bfloat16
    _check(got, plain(x, w, smap, dmap), tol=8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 5, 7, 24, 40), (1, 3, 5, 200, 136),
                                         (1, 70, 60, 24, 136)])
def test_patch_mod_conv3_bf16_kernel_ragged_edges(card, B, H, W, Ci, Co):
    """bf16 tiles that overhang H, W, Ci (a half K step) and Co; no dmap."""
    for up in (False, True):
        x, w, smap, _ = (t.bfloat16() for t in _inputs(H, Ci, Co, card, B=B, W=W, up=up))
        fn, plain = ((pmc.patch_mod_conv3_up_nhwc, pmc.patch_mod_conv3_up_nhwc_plain)
                     if up else (pmc.patch_mod_conv3_nhwc, pmc.patch_mod_conv3_nhwc_plain))
        _check(fn(x, w, smap, None), plain(x, w, smap, None), tol=8e-3)


def _bf16_entries(up):
    return ((pmc.patch_mod_conv3_up_nhwc, pmc.patch_mod_conv3_up_nhwc_plain)
            if up else (pmc.patch_mod_conv3_nhwc, pmc.patch_mod_conv3_nhwc_plain))


# every (pixel tile, K splits) that plan_bf16 can pick
BF16_CONFIGS = [(th, tw, splits) for th, tw in ((8, 8), (8, 16), (16, 16))
                for splits in (1, 2, 4, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("th,tw,splits", BF16_CONFIGS)
def test_patch_mod_conv3_bf16_every_tile_and_cluster(card, monkeypatch, th, tw,
                                                     splits, up):
    """The bf16 kernel at each tile and split-K cluster (forced past the
    plan), on a ragged grid (H, W not multiples of the tile; 3 tiles, not a
    multiple of any cluster of 2-8), Co = 192 and 8 chunks of 32 channels:
    against the plain version, and bit for bit across two calls (the
    cluster's split sum runs in rank order)."""
    monkeypatch.setattr(pmc, "plan_bf16", lambda *a: (th, tw, splits))
    H, W = 2 * th + 3, tw - 3  # 3 x 1 tiles, each overhanging the image
    assert -(-H // th) * -(-W // tw) == 3
    x, w, smap, dmap = (t.bfloat16() for t in _inputs(H, 256, 192, card, B=2, W=W, up=up))
    fn, plain = _bf16_entries(up)
    a = fn(x, w, smap, dmap)
    b = fn(x, w, smap, dmap)
    _check(a, plain(x, w, smap, dmap), tol=8e-3)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,Ci,Co", [(1, 9, 13, 40, 192), (2, 17, 33, 24, 192),
                                         (1, 19, 21, 40, 136), (1, 64, 64, 24, 8)])
def test_patch_mod_conv3_bf16_kernel_ragged_chunks(card, B, H, W, Ci, Co):
    """Ci = 24 and 40 (a part-filled 32-channel chunk), Co = 192, 136 and 8
    (a part-filled 128-channel block, scalar stores past a whole 8), H and
    W not multiples of any tile; both entries, with and without dmap."""
    for up in (False, True):
        x, w, smap, dmap = (t.bfloat16() for t in _inputs(H, Ci, Co, card, B=B, W=W, up=up))
        fn, plain = _bf16_entries(up)
        _check(fn(x, w, smap, dmap), plain(x, w, smap, dmap), tol=8e-3)
        _check(fn(x, w, smap, None), plain(x, w, smap, None), tol=8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("H,Ci,Co", [(4, 512, 512), (16, 512, 512), (64, 512, 256)])
def test_patch_mod_conv3_bf16_repeats_bitwise_at_the_plan(card, H, Ci, Co, up):
    """The plan's own launches at batch 1 and 8: the cluster split-K of
    4^2 and 16^2 and the unsplit 16x16 tiles of 64^2 (64->128 up); two
    launches agree bit for bit."""
    for B in (1, 8):
        x, w, smap, dmap = (t.bfloat16() for t in _inputs(H, Ci, Co, card, B=B, up=up))
        fn, _ = _bf16_entries(up)
        a = fn(x, w, smap, dmap)
        b = fn(x, w, smap, dmap)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def _bf16_product(x, s):
    """The bf16 kernel's A-operand product alone (mul.rn.bf16x2, through
    the library's test entry ``patch_mod_conv3_bf16_product``): x * s
    elementwise on two contiguous bf16 CUDA tensors of one even size."""
    fn = pmc._load()[torch.bfloat16].patch_mod_conv3_bf16_product
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel() // 2,
             torch.cuda.current_stream(x.device).cuda_stream)
    assert err == 0, f"cudaError {err}"
    return out


@pytest.mark.cuda
def test_bf16_product_is_the_f32_product_rounded_once(card):
    """The kernel's A operand (mul.rn.bf16x2) bit for bit against the exact
    f32 product of two bf16 values rounded once to bf16, on main-path
    values (x ~ N(0,1), smap ~ 1 + N(0,0.5^2)) and on values spread over
    2^-60 .. 2^60 of both signs."""
    g = torch.Generator(device=card).manual_seed(0)
    n = 1 << 22
    x = torch.randn(n, generator=g, device=card).bfloat16()
    s = (1 + 0.5 * torch.randn(n, generator=g, device=card)).bfloat16()
    mag = torch.exp2(torch.randint(-60, 61, (2, n), generator=g, device=card).float())
    sign = torch.randint(0, 2, (2, n), generator=g, device=card).float() * 2 - 1
    u = (sign * mag * (1 + torch.rand((2, n), generator=g, device=card))).bfloat16()
    for a, b in ((x, s), (u[0], u[1])):
        got = _bf16_product(a, b)
        want = (a.float() * b.float()).bfloat16()
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_patch_mod_conv3_bf16_refused_cluster_raises(card, monkeypatch):
    """A cluster the C entry refuses (16 splits, not portable, though Ci
    has 16 chunks) raises; no launch is counted."""
    monkeypatch.setattr(pmc, "plan_bf16", lambda *a: (8, 8, 16))
    x, w, smap, dmap = (t.bfloat16() for t in _inputs(8, 512, 64, card))
    before = pmc.patch_mod_conv3_nhwc.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        pmc.patch_mod_conv3_nhwc(x, w, smap, dmap)
    assert pmc.patch_mod_conv3_nhwc.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True])
def test_bf16_model_packs_bf16_tiles_and_rebuilds_them(card, up):
    """A layer cast to bf16 packs bf16 tiles (the bf16 kernel's layout);
    cast back, it packs f32 TF32-split tiles again; both run the kernel."""
    torch.manual_seed(0)
    layer = ModulatedConv2d(32, 16, 3, 64, upsample=up).to(card)
    with torch.no_grad():
        layer.weight.normal_()
        layer.modulation.weight.normal_()
        layer.modulation.bias.fill_(1.0)
    layer.requires_grad_(False)
    x = torch.randn(2, 32, 8, 8, device=card).contiguous(memory_format=torch.channels_last)
    style = torch.randn(2, 12, 64, device=card)
    lab = torch.randint(0, 12, (2, 16, 16), device=card)
    mask = (lab[:, None] == torch.arange(12, device=card)[None, :, None, None]).float()
    for dt in (torch.bfloat16, torch.float32):
        layer.to(dt)
        before = pmc.patch_mod_conv3_nhwc.launches
        out = layer(x.to(dt), style.to(dt), mask.to(dt))
        assert pmc.patch_mod_conv3_nhwc.launches == before + 1
        wk, packed = layer._kernel_weights
        assert wk.dtype == packed.dtype == dt and out.dtype == dt
        assert tuple(packed.shape) == pmc.packed_shape(4 if up else 1, 16, 32, dt)
        assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_inversion_step_gradient_on_the_card_matches_the_cpu(card, tmp_path):
    """One inversion step's loss and style-vector gradient (64^2, K = 7,
    every criterion) on the card against the CPU's, seeded weights: the
    forward runs the kernel (7 launches), the backward its plain version.
    1e-3 relative max: the card's convolutions, f32 with TF32 off, sum in
    another order, and the demodulation's scale invariance cancels the
    gradient to a fraction of its parts (tests/test_torch_inversion.py)."""
    from e4s_tpu_torch.datasets.dataset import SyntheticFaceDataset, label_map_to_onehot
    from e4s_tpu_torch.pipelines.optimization import Optimizer

    opts = types.SimpleNamespace(
        num_seg_cls=12, out_size=64, remaining_layer_idx=7, n_styles=10,
        start_from_latent_avg=True, encoder_size=64, checkpoint_path=None,
        dataset_root=str(tmp_path), ds_frac=1.0, lr=0.01, opt_name="adam",
        W_steps=1, optimize_noise=False, bf16=False, save_intermediate=False,
        save_interval=50, output_dir=str(tmp_path), lpips_lambda=0.8,
        id_lambda=0.1, id_loss_multiscale=True, face_parsing_lambda=0.1,
        l2_lambda=1.0, ir_se50_path=None, face_parsing_model_path=None)
    img, label, _ = SyntheticFaceDataset(size=64)[3]
    onehot = label_map_to_onehot(label[None], 12)
    sv = np.random.RandomState(4).rand(1, 12, 1280).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        opt = Optimizer(opts, device=dev, seed=5)
        sv_t = torch.from_numpy(sv).to(dev).requires_grad_(True)
        pmc.patch_mod_conv3_nhwc.launches = 0
        recon = opt.gen_from_sv(sv_t, torch.from_numpy(onehot).to(dev))
        loss, _ = opt.calc_loss(torch.from_numpy(img[None]).to(dev), recon)
        (g,) = torch.autograd.grad(loss, sv_t)
        assert pmc.patch_mod_conv3_nhwc.launches == (7 if dev == "cuda" else 0)
        res[dev] = (loss.item(), g.cpu().numpy())
    (lc, gc), (lp, gp) = res["cuda"], res["cpu"]
    assert np.isfinite(gc).all() and np.abs(gp).max() > 0
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    assert np.abs(gc - gp).max() <= 1e-3 * np.abs(gp).max()


# ---------------------------------------------------------------- training


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Ci,Co,up", [(16, 512, 512, False), (8, 512, 512, True),
                                        (64, 512, 256, True)])
def test_patch_mod_conv3_gradients_match_plain(card, dtype, H, Ci, Co, up):
    """The gradients through ``_PatchModConv3`` (kernel forward, plain
    backward) w.r.t. x, the weights (the up-conv's four phase weights),
    smap and dmap at batch 2, against autograd through the plain version on
    the same inputs: the forward's tolerance (the backward re-runs the plain
    version, so only the upstream gradient may differ)."""
    x, w, smap, dmap = (t.to(dtype).requires_grad_(True)
                        for t in _inputs(H, Ci, Co, card, B=2, up=up))
    r = torch.randn((2, 2 * H if up else H, 2 * H if up else H, Co),
                    generator=torch.Generator(device=card).manual_seed(7),
                    device=card).to(dtype)
    kern = pmc.patch_mod_conv3_up_nhwc if up else pmc.patch_mod_conv3_nhwc
    plain = pmc.patch_mod_conv3_up_nhwc_plain if up else pmc.patch_mod_conv3_nhwc_plain
    pmc.patch_mod_conv3_nhwc.launches = 0
    got = torch.autograd.grad((kern(x, w, smap, dmap) * r).float().sum(), (x, w, smap, dmap))
    assert pmc.patch_mod_conv3_nhwc.launches == 1
    want = torch.autograd.grad((plain(x, w, smap, dmap) * r).float().sum(),
                               (x, w, smap, dmap))
    tol = 1e-4 if dtype == torch.float32 else 8e-3
    for g, v in zip(got, want):
        _check(g, v, tol)


@pytest.mark.cuda
def test_masked_up_conv_weight_gradient_matches_the_region_loop(card):
    """The gradient w.r.t. the 3x3 weight of a masked up-conv: kernel
    forward on the polyphase weights built from it, plain backward through
    them, against the reference's 12-conv region loop on the card."""
    from e4s_tpu_torch.ops import modconv

    g = torch.Generator(device=card).manual_seed(8)
    x = torch.randn((2, 64, 16, 16), generator=g, device=card).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn((32, 64, 3, 3), generator=g, device=card) / 24).requires_grad_(True)
    s = 1 + 0.3 * torch.randn((2, 12, 64), generator=g, device=card)
    label = torch.randint(0, 12, (2, 32, 32), generator=g, device=card)
    mask = torch.nn.functional.one_hot(label, 12).permute(0, 3, 1, 2).float()
    r = torch.randn((2, 32, 32, 32), generator=g, device=card).permute(0, 3, 1, 2)
    pmc.patch_mod_conv3_nhwc.launches = 0
    (got,) = torch.autograd.grad(
        (modconv.masked_modulated_conv2d(x, w, s, mask, up=True) * r).sum(), w)
    assert pmc.patch_mod_conv3_nhwc.launches == 1
    (want,) = torch.autograd.grad(
        (modconv.masked_modulated_conv2d_naive(x, w, s, mask, up=True) * r).sum(), w)
    _check(got, want)


@pytest.mark.cuda
def test_coach_g_and_d_steps_on_the_card_match_the_cpu(card, tmp_path):
    """One Coach G step and one D step (16^2, K = 5, the small-model knobs
    of tests/test_torch_training_steps.py), each from the same seeded weights,
    batch and noise (the registered maps) on the card and on the CPU: the
    losses within 1e-4 of max(|CPU value|, 1) (D's scores are means of
    logits near 0), the update's sign differing in at most 1% of the
    elements (Adam's first step is +-lr), 5 launches a step."""
    from e4s_tpu_torch.datasets.dataset import SyntheticFaceDataset, label_map_to_onehot
    from e4s_tpu_torch.options.train_options import TrainOptions
    from e4s_tpu_torch.training.coach import Coach

    ds = SyntheticFaceDataset(size=16)
    img = np.stack([ds[i][0] for i in (1, 2)])
    label = np.stack([ds[i][1] for i in (1, 2)]).astype(np.int32)
    batch = (img, label, label_map_to_onehot(label, 12))
    res = {}
    for dev in ("cuda", "cpu"):
        opts = TrainOptions().parse([
            "--device", dev, "--exp_dir", str(tmp_path / dev), "--out_size", "16",
            "--remaining_layer_idx", "5", "--n_styles", "6", "--id_lambda", "0",
            "--face_parsing_lambda", "0", "--w_norm_lambda", "0.01",
            "--latent_avg_samples", "16", "--stylegan_weights", ""])
        opts.encoder_size, opts.encoder_slim, opts.ch_div = 32, True, 8
        img_t, label_t, onehot_t = (torch.from_numpy(a).to(dev) for a in batch)
        out = {}
        for key in ("g", "d"):  # each from the seeded weights
            coach = Coach(opts)
            G = coach.net.G
            noise = [getattr(G.noises, f"noise_{i}") for i in range(G.num_layers)]
            m = coach.net if key == "g" else coach.D
            before = {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
            pmc.patch_mod_conv3_nhwc.launches = 0
            if key == "g":
                losses = coach._g_step(img_t, label_t, onehot_t, noise=noise)
            else:
                losses = coach._d_step(img_t, onehot_t, noise=noise)
            out[key] = ({k: float(v) for k, v in losses.items()},
                        {n: torch.sign(p.detach().cpu() - before[n])
                         for n, p in m.named_parameters()},
                        pmc.patch_mod_conv3_nhwc.launches)
        res[dev] = out
    for key in ("g", "d"):
        (lc, sc, nc), (lp, sp, npl) = res["cuda"][key], res["cpu"][key]
        assert (nc, npl) == (5, 0)
        assert set(lc) == set(lp)
        for k in lp:
            assert abs(lc[k] - lp[k]) <= 1e-4 * max(abs(lp[k]), 1.0), (key, k, lc[k], lp[k])
        differ = sum(int((sc[n] != sp[n]).sum()) for n in sp)
        assert differ <= 1e-2 * sum(t.numel() for t in sp.values()), (key, differ)


# the re-enact -> restore chain at a small size: fv2v at 16^2 with narrow
# nets, RealESRNet with 1 block, GPEN at 32; the swap at 64^2 (K=7)
CHAIN_FV2V = dict(
    size=16, kp_kwargs=dict(block_expansion=8, max_features=64, reshape_channel=128,
                            reshape_depth=4, num_blocks=2),
    gen_kwargs=dict(feature_channel=4, block_expansion=64, max_features=16,
                    num_down_blocks=2, reshape_channel=4, reshape_depth=4,
                    num_resblocks=1, dense_motion_params=dict(
                        block_expansion=8, num_blocks=2, max_features=32)))
CHAIN_GPEN = {"in_size": 32, "force_one_face": True}
# D card vs CPU: cuDNN sums in another order, so a value on a rounding
# boundary moves a level, and at random weights a ParseNet argmax on a near
# tie can flip and move the feathered mask: 40 dB; the final swap amplifies
# D's differences through the pooled style codes: 30 dB, the JAX package's
# bar at random weights
CHAIN_PSNR_D, CHAIN_PSNR_SWAP = 40.0, 30.0


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _chain_swapper(dev):
    from e4s_tpu_torch.models.facevid2vid.driver import build_reenactor
    from e4s_tpu_torch.models.gpen.face_enhancement import build_restorer
    from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet
    from e4s_tpu_torch.pipelines.model_io import materialise

    opts = types.SimpleNamespace(
        num_seg_cls=12, out_size=64, remaining_layer_idx=7, n_styles=10,
        start_from_latent_avg=True, encoder_size=64, parser_size=64)
    restorer = build_restorer(CHAIN_GPEN, device=dev, seed=4)
    restorer.srmodel = materialise(lambda: RRDBNet(scale=4, num_block=1), None, 5, dev)
    return FaceSwapper(opts, device=dev, seed=2,
                       reenactor=build_reenactor(None, device=dev, seed=3, **CHAIN_FV2V),
                       restorer=restorer)


def _chain_pair():
    rng = np.random.RandomState(5)
    return [np.kron(rng.randint(0, 256, (1, 3, 8, 8)), np.ones((8, 8))).astype(np.uint8)
            for _ in range(2)]


@pytest.mark.cuda
def test_reenact_restore_swap_on_the_card_matches_the_cpu(card):
    """The chain (the stand-in face of ``force_one_face``) and the fused swap
    after it, card against CPU; 7 kernel launches on the card."""
    s, t = _chain_pair()
    out = {}
    for dev in ("cuda", "cpu"):
        swapper = _chain_swapper(dev)
        d = swapper.chain(torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
        pmc.patch_mod_conv3_nhwc.launches = 0
        img = swapper.swap_from_arrays(s / 255.0, t / 255.0)
        assert pmc.patch_mod_conv3_nhwc.launches == (7 if dev == "cuda" else 0)
        assert len(swapper.chain.last_faces) == 1
        out[dev] = (d.cpu().numpy(), np.asarray(img))
    assert _psnr(out["cuda"][0], out["cpu"][0]) >= CHAIN_PSNR_D
    assert _psnr(out["cuda"][1], out["cpu"][1]) >= CHAIN_PSNR_SWAP


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["two faces", "face under 100 px", "no face"])
def test_reenact_restore_branches_on_the_card_match_the_cpu(card, branch):
    """The branches the JAX chain leaves to its host glue, with the
    detections fed in (boxes, landmarks and scores at the SR's 64^2)."""
    pts = np.array([[0.38, 0.62, 0.50, 0.40, 0.60], [0.42, 0.42, 0.55, 0.70, 0.70]])

    def face(x0, y0, side, score):
        return ([x0, y0, x0 + side, y0 + side, score],
                np.concatenate([x0 + side * pts[0], y0 + side * pts[1]]))

    faces = {"two faces": [face(4, 4, 40, 0.95), face(24, 20, 36, 0.99)],
             "face under 100 px": [face(12, 10, 40, 0.97)],
             "no face": [face(12, 10, 40, 0.5)]}[branch]
    s, t = _chain_pair()
    out = {}
    for dev in ("cuda", "cpu"):
        chain = _chain_swapper(dev).chain
        dets = torch.tensor([f[0] for f in faces], dtype=torch.float32, device=dev)
        lms = torch.tensor(np.stack([f[1] for f in faces]), dtype=torch.float32, device=dev)
        chain._det_stage = lambda up: (dets[:, :4], lms, dets[:, 4])
        chain.enh.force_one_face = False
        d = chain(torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
        out[dev] = (d.cpu().numpy(), len(chain.last_faces))
    want = {"two faces": 2, "face under 100 px": 1, "no face": 0}[branch]
    assert out["cuda"][1] == out["cpu"][1] == want
    assert _psnr(out["cuda"][0], out["cpu"][0]) >= CHAIN_PSNR_D
