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

import math
import types

import numpy as np
import pytest
import torch

from e4s_tpu_torch.models.stylegan2 import ModulatedConv2d
from e4s_tpu_torch.ops import conv3x3 as c3
from e4s_tpu_torch.ops import conv3x3_n32 as n32
from e4s_tpu_torch.ops import kernel_lib
from e4s_tpu_torch.ops import patch_modconv as pmc
from e4s_tpu_torch.ops import styled_conv as sc
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
    one launch each; the two unmasked StyledConvs at 64^2, one launch each)
    on the card and on the CPU, where the kernels' plain versions run
    instead."""
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
        pmc.patch_mod_conv3_nhwc.launches = sc.styled_conv3.launches = 0
        out[dev] = np.asarray(swapper.swap_from_arrays(src, tgt), np.float64)
        assert pmc.patch_mod_conv3_nhwc.launches == (7 if dev == "cuda" else 0)
        assert sc.styled_conv3.launches == (2 if dev == "cuda" else 0)
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
    P, I = kernel_lib.PTR, kernel_lib.INT
    fn = kernel_lib.load("patch_mod_conv3_bf16", {
        "patch_mod_conv3_bf16_product": [P] * 3 + [I, P]}).patch_mod_conv3_bf16_product
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
        wk, packed = layer._kernel_cache.value
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
    """The gradients through ``kernel_lib.PlainGrad`` (kernel forward, plain
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
    after it, card against CPU; 7 masked-conv launches and 2 of the unmasked
    StyledConv on the card, none of either in the chain (GPEN keeps its
    own path)."""
    s, t = _chain_pair()
    out = {}
    for dev in ("cuda", "cpu"):
        swapper = _chain_swapper(dev)
        sc.styled_conv3.launches = 0
        d = swapper.chain(torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
        assert sc.styled_conv3.launches == 0
        pmc.patch_mod_conv3_nhwc.launches = 0
        img = swapper.swap_from_arrays(s / 255.0, t / 255.0)
        assert pmc.patch_mod_conv3_nhwc.launches == (7 if dev == "cuda" else 0)
        assert sc.styled_conv3.launches == (2 if dev == "cuda" else 0)
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


# ------------------------------------------------- the encoder's 3x3 conv

# (H=W, Ci, Co) of every stride-1 3x3 conv of FSEncoderPSP's trunk at 256^2
ENCODER_SHAPES = [(256, 64, 128), (128, 128, 128), (128, 128, 256), (64, 256, 256),
                  (64, 256, 512), (32, 512, 512), (16, 512, 512)]


def _conv3_inputs(B, H, W, Ci, Co, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + H * 1000 + Ci + Co)
    x = torch.randn((B, H, W, Ci), generator=g, device=dev)
    w = torch.randn((Co, Ci, 3, 3), generator=g, device=dev) / math.sqrt(9 * Ci)
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 16])
@pytest.mark.parametrize("H,Ci,Co", ENCODER_SHAPES)
def test_conv3x3_kernel_matches_conv2d_at_the_encoder_shapes(card, B, H, Ci, Co):
    """The kernel at its plan against ``F.conv2d`` with TF32 off (the plain
    version), one launch each."""
    x, w = _conv3_inputs(B, H, H, Ci, Co, card)
    before = c3.conv3x3_nhwc.launches
    got = c3.conv3x3_nhwc(x, w)
    assert c3.conv3x3_nhwc.launches == before + 1
    assert got.shape == (B, H, H, Co) and got.is_contiguous()
    _check(got, c3.conv3x3_nhwc_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("th,tw", c3.TILES)
@pytest.mark.parametrize("B,H,W,Ci,Co,splits", [
    (2, 5, 7, 24, 40, 1), (1, 9, 130, 16, 8, 1), (1, 3, 5, 200, 136, 4),
    (1, 70, 60, 20, 136, 2), (3, 17, 33, 12, 45, 1), (2, 19, 21, 40, 200, 3)])
def test_conv3x3_kernel_ragged_edges(card, monkeypatch, th, tw, B, H, W, Ci, Co, splits):
    """Every tile, forced past the plan, on H and W that overhang it, Co not
    a multiple of 128 (odd: single stores), Ci not a multiple of 8 (a half
    K step), split K with an empty or a short last split; bit for bit across
    two calls."""
    monkeypatch.setattr(c3, "plan", lambda *a: (th, tw, splits))
    x, w = _conv3_inputs(B, H, W, Ci, Co, card)
    a = c3.conv3x3_nhwc(x, w)
    b = c3.conv3x3_nhwc(x, w)
    _check(a, c3.conv3x3_nhwc_plain(x, w))
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Ci,Co", [(2, 16, 512, 512), (2, 32, 512, 512),
                                       (2, 64, 256, 256), (16, 16, 512, 512),
                                       (16, 64, 256, 256)])
def test_conv3x3_kernel_repeats_bitwise_at_the_plan(card, B, H, Ci, Co):
    """The plan's own launches (split K at B = 2 and at 16^2, none at 64^2
    and B = 16): two launches agree bit for bit."""
    x, w = _conv3_inputs(B, H, H, Ci, Co, card)
    packed = pmc.pack_weight(w)
    a = c3.conv3x3_nhwc(x, w, packed)
    b = c3.conv3x3_nhwc(x, w, packed)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_conv3x3_kernel_rejects_bad_inputs(card):
    x, w = _conv3_inputs(2, 8, 8, 16, 32, card)
    before = c3.conv3x3_nhwc.launches
    with pytest.raises(ValueError):
        c3.conv3x3_nhwc(x.transpose(1, 2), w)
    with pytest.raises(TypeError):
        c3.conv3x3_nhwc(x.double(), w.double())
    with pytest.raises(TypeError):
        c3.conv3x3_nhwc(x.bfloat16(), w)
    with pytest.raises(ValueError):
        c3.conv3x3_nhwc(x[..., :6].contiguous(), w[:, :6].contiguous())
    with pytest.raises(ValueError):
        c3.conv3x3_nhwc(x, w[:, :8].contiguous())
    with pytest.raises(ValueError):
        c3.conv3x3_nhwc(x, w.cpu())
    with pytest.raises(ValueError):
        c3.conv3x3_nhwc(x, w, pmc.pack_weight(w[:, :8].contiguous()))
    assert c3.conv3x3_nhwc.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Ci,Co", [(2, 16, 512, 512), (2, 64, 256, 256),
                                       (3, 9, 12, 45)])
def test_conv3x3_gradients_match_conv2d(card, B, H, Ci, Co):
    """The gradients through ``kernel_lib.PlainGrad`` (kernel forward, plain
    backward) w.r.t. x and the weight, against autograd through ``F.conv2d``."""
    x, w = (t.requires_grad_(True) for t in _conv3_inputs(B, H, H, Ci, Co, card))
    r = torch.randn((B, H, H, Co), generator=torch.Generator(device=card).manual_seed(9),
                    device=card)
    c3.conv3x3_nhwc.launches = 0
    got = torch.autograd.grad((c3.conv3x3_nhwc(x, w) * r).sum(), (x, w))
    assert c3.conv3x3_nhwc.launches == 1
    want = torch.autograd.grad(
        (torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
         .permute(0, 2, 3, 1) * r).sum(), (x, w))
    for g, v in zip(got, want):
        _check(g, v)


@pytest.mark.cuda
def test_encoder_on_the_card_matches_the_cpu_and_stays_nchw(card):
    """FSEncoderPSP at 256^2, batch 2 (the full trunk, seeded weights): 44
    kernel launches, codes within 1e-4 of max |CPU codes|, NCHW outputs."""
    from e4s_tpu_torch.models.encoders import FSEncoderPSP
    from e4s_tpu_torch.models.layers import init_module_

    enc = init_module_(FSEncoderPSP(), torch.Generator().manual_seed(11)).eval()
    g = torch.Generator().manual_seed(12)
    x = torch.randn((2, 3, 256, 256), generator=g)
    seg = torch.nn.functional.one_hot(torch.randint(0, 12, (2, 256, 256), generator=g), 12)
    seg = seg.permute(0, 3, 1, 2).float()
    with torch.no_grad():
        want, _ = enc(x, seg)
        enc.to(card)
        c3.conv3x3_nhwc.launches = 0
        got, feats = enc(x.to(card), seg.to(card))
    assert c3.conv3x3_nhwc.launches == 44
    assert feats.is_contiguous() and got.is_contiguous()
    _check(got.cpu(), want)


@pytest.mark.cuda
def test_swap_and_swap_batch_launch_44_conv3x3_in_f32_and_none_in_bf16(card):
    """A 1024^2 swapper (18 styles, K = 13, seeded weights): 44 conv3x3
    launches per swap and per ``swap_batch`` chunk in f32 and none with
    ``bf16``, 13 masked-conv launches each; the four unmasked StyledConvs
    are 4 launches of their kernel in f32 and none in bf16."""
    opts = dict(num_seg_cls=12, out_size=1024, remaining_layer_idx=13, n_styles=18,
                start_from_latent_avg=True)
    rng = np.random.RandomState(6)
    pairs = [np.kron(rng.randint(0, 256, (2, 3, 16, 16)), np.ones((64, 64))).astype(np.uint8)
             for _ in range(2)]
    for bf16, want in ((False, 44), (True, 0)):
        swapper = FaceSwapper(types.SimpleNamespace(**opts, bf16=bf16), device="cuda", seed=0)
        styled = 0 if bf16 else 4
        c3.conv3x3_nhwc.launches = pmc.patch_mod_conv3_nhwc.launches = 0
        sc.styled_conv3.launches = 0
        swapper.swap_from_arrays(pairs[0][:1] / 255.0, pairs[1][:1] / 255.0)
        assert (c3.conv3x3_nhwc.launches, pmc.patch_mod_conv3_nhwc.launches) == (want, 13)
        assert sc.styled_conv3.launches == styled
        c3.conv3x3_nhwc.launches = pmc.patch_mod_conv3_nhwc.launches = 0
        sc.styled_conv3.launches = 0
        swapper.swap_batch(pairs[0], pairs[1], chunk=2)
        assert (c3.conv3x3_nhwc.launches, pmc.patch_mod_conv3_nhwc.launches) == (want, 13)
        assert sc.styled_conv3.launches == styled
        del swapper
        torch.cuda.empty_cache()


# ------------------------------------------ RealESRNet's 32-channel conv

# (H=W, Ci, up) of every conv of RealESRNet x4 at its 256^2 input (the
# trunk, conv_body, conv_up1, conv_up2, conv_hr), and the trunk's 32 -> 32
# at 512^2 (GPEN's aligned SR) and 1024^2
N32_SHAPES = [(256, 32, False), (256, 64, False), (256, 96, False), (256, 128, False),
              (256, 160, False), (512, 32, True), (1024, 32, True), (1024, 32, False),
              (512, 32, False)]
# (B, H, W, Ci): tiles (16 x 16) that overhang H and W, Ci not a multiple of
# 8 (a half stage), batch > 1
N32_RAGGED = [(2, 5, 7, 12), (1, 33, 17, 36), (1, 70, 45, 100), (3, 31, 50, 4),
              (1, 64, 64, 160)]


def _n32_inputs(B, H, W, Ci, dev, C=None, seed=0):
    """x [B,H,W,C] (C >= Ci channels), w [32,Ci,3,3], b [32]."""
    g = torch.Generator(device=dev).manual_seed(seed + H * 1000 + W + Ci)
    x = torch.randn((B, H, W, C or Ci), generator=g, device=dev)
    w = torch.randn((32, Ci, 3, 3), generator=g, device=dev) / math.sqrt(9 * Ci)
    b = torch.randn((32,), generator=g, device=dev) * 0.1
    return x, w, b


def _n32_plain(x, w, b, ci, **kw):
    return n32.conv_plain(x[..., :ci], w, b, **kw)


def _equal(got, want):
    """Bit for bit: the kernel runs cuDNN's chain of FMAs (with TF32 off) in
    cuDNN's order, and rounds its epilogue as PyTorch's passes do."""
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("H,Ci,up", N32_SHAPES)
def test_conv3x3_n32_kernel_is_conv2d_bit_for_bit_at_realesrnet_shapes(card, H, Ci, up):
    """One launch against ``F.conv2d`` with TF32 off at every shape of the
    SR (``up``: the input is the half-size map, upsampled in the load)."""
    s = 2 if up else 1
    x, w, b = _n32_inputs(1, H // s, H // s, Ci, card)
    before = n32.conv3x3_n32.launches
    got = n32.conv3x3_n32(x, w, b, up=up)
    assert n32.conv3x3_n32.launches == before + 1
    assert got.shape == (1, H, H, 32)
    _equal(got, _n32_plain(x, w, b, Ci, up=up))


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("B,H,W,Ci", N32_RAGGED)
def test_conv3x3_n32_kernel_ragged_edges(card, B, H, W, Ci, up):
    """H and W that overhang the tile, a half stage, batch > 1 (where cuDNN
    may sum in another order: within 1e-4 of max |plain|); bit for bit
    across two calls."""
    x, w, b = _n32_inputs(B, H, W, Ci, card)
    a = n32.conv3x3_n32(x, w, b, up=up, lrelu=True)
    c = n32.conv3x3_n32(x, w, b, up=up, lrelu=True)
    _check(a, _n32_plain(x, w, b, Ci, up=up, lrelu=True))
    assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["bias", "lrelu", "r1", "r1 r2", "out is r2"])
def test_conv3x3_n32_prefix_read_offset_write_and_epilogues(card, epilogue):
    """Channels [0, 96) of a 160-channel buffer in, channels [96, 128) of
    the same buffer out (a dense block's conv3), or channels [0, 32) of
    another buffer with one or two residuals (conv5; the third block's conv5
    writes over its second residual); every other channel untouched."""
    x, w, b = _n32_inputs(1, 40, 56, 96, card, C=160)
    r1 = torch.randn((1, 40, 56, 160), generator=torch.Generator(device=card).manual_seed(1),
                     device=card)
    r2 = torch.randn((1, 40, 56, 64), generator=torch.Generator(device=card).manual_seed(2),
                     device=card)
    kw = {"bias": {}, "lrelu": dict(lrelu=True), "r1": dict(r1=r1, a1=0.2),
          "r1 r2": dict(r1=r1, a1=0.2, r2=r2, a2=0.2),
          "out is r2": dict(r1=r1, a1=0.2, r2=r2, a2=0.2)}[epilogue]
    want = _n32_plain(x, w, b, 96, **{k: v[..., :32] if torch.is_tensor(v) else v
                                      for k, v in kw.items()})
    if epilogue in ("bias", "lrelu"):
        out, oc = x, 96
    else:
        out = r2 if epilogue == "out is r2" else torch.randn_like(r2)
        oc = 0
    keep = out.clone()
    got = n32.conv3x3_n32(x, w, b, ci=96, out=out, oc=oc, **kw)
    assert got is out
    _check(out[..., oc:oc + 32], want)
    assert torch.equal(out[..., :oc], keep[..., :oc])
    assert torch.equal(out[..., oc + 32:], keep[..., oc + 32:])


@pytest.mark.cuda
def test_conv3x3_n32_kernel_rejects_bad_inputs(card):
    x, w, b = _n32_inputs(1, 16, 16, 64, card, C=96)
    before = n32.conv3x3_n32.launches
    with pytest.raises(TypeError):
        n32.conv3x3_n32(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        n32.conv3x3_n32(x.transpose(1, 2), w, b, ci=64)
    with pytest.raises(ValueError):
        n32.conv3x3_n32(x, w.cpu(), b, ci=64)
    with pytest.raises(ValueError):  # not 32 output channels
        n32.conv3x3_n32(x, w[:16].contiguous(), b[:16], ci=64)
    with pytest.raises(RuntimeError):  # reads past x's channels
        n32.conv3x3_n32(x[..., :48].contiguous(), w, b, ci=64)
    with pytest.raises(RuntimeError):  # Ci not a multiple of 4
        n32.conv3x3_n32(x, w[:, :6].contiguous(), b, ci=6)
    with pytest.raises(RuntimeError):  # writes past out's channels
        n32.conv3x3_n32(x, w, b, ci=64, out=torch.empty_like(x), oc=80)
    with pytest.raises(RuntimeError):  # writes over the channels it reads
        n32.conv3x3_n32(x, w, b, ci=64, out=x, oc=32)
    with pytest.raises(RuntimeError):  # out is not 2x x for up
        n32.conv3x3_n32(x, w, b, ci=64, up=True, out=torch.empty_like(x), oc=0)
    assert n32.conv3x3_n32.launches == before


def _sr_net(dev, seed=7):
    from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet
    from e4s_tpu_torch.pipelines.model_io import materialise

    return materialise(lambda: RRDBNet(scale=4), None, seed, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [256, 512])
def test_realesrnet_on_the_kernel_is_its_modules_bit_for_bit(card, monkeypatch, H):
    """RealESRNet x4 (23 blocks, seeded weights) on the kernel path against
    its modules as written (cuDNN, TF32 off): the same float image and the
    same uint8 SR image, bit for bit, in 349 launches a forward."""
    from e4s_tpu_torch.pipelines.reenact_restore import sr_u8

    net = _sr_net(card)
    img = torch.randint(0, 256, (1, 3, H, H), generator=torch.Generator(device=card)
                        .manual_seed(H), device=card, dtype=torch.uint8)
    with torch.no_grad():
        n32.conv3x3_n32.launches = 0
        got = net(img.float() / 255.0)
        got_u8 = sr_u8(net, img)
        assert n32.conv3x3_n32.launches == 2 * 349
        monkeypatch.setattr(n32, "kernel_takes", lambda *a: False)
        want = net(img.float() / 255.0)
        want_u8 = sr_u8(net, img)
    assert n32.conv3x3_n32.launches == 2 * 349
    _equal(got, want)
    _equal(got_u8, want_u8)


@pytest.mark.cuda
def test_sr_launches_349_n32_convs_in_f32_and_none_in_bf16(card):
    """The chain's SR stage: 349 launches of the 32-channel conv per forward
    in f32; the ``bf16`` chain's deep copy runs its bf16 modules (none)."""
    from e4s_tpu_torch.pipelines.reenact_restore import DeviceRestore, sr_u8

    enh = types.SimpleNamespace(srmodel=_sr_net(card), facedetector=torch.nn.Identity(),
                                facegan=torch.nn.Identity(), faceparser=torch.nn.Identity())
    img = torch.randint(0, 256, (1, 3, 64, 48), device=card, dtype=torch.uint8)
    for bf16, want in ((False, 349), (True, 0)):
        restore = DeviceRestore(enh, bf16=bf16)
        n32.conv3x3_n32.launches = 0
        with torch.no_grad():
            out = sr_u8(restore.sr, img, restore.act)
        torch.cuda.synchronize()
        assert out.shape == (1, 3, 256, 192)
        assert n32.conv3x3_n32.launches == want


# ------------------------------------------------- the unmasked StyledConv

# (input H=W, Ci, Co, up) of the four unmasked StyledConvs of a 1024^2
# synthesis at K = 13 (layers 13-16)
STYLED_SHAPES = [(256, 128, 64, True), (512, 64, 64, False), (512, 64, 32, True),
                 (1024, 32, 32, False)]
# (B, H, W, Ci, Co, up): tiles that overhang H and W (8 or 16 x 16), the
# last N block partial (Co 40 up: 160 columns; Co 24), odd Co (single
# stores), Ci not a multiple of 8 (a half K step), ch_div's narrow widths (8)
STYLED_RAGGED = [(2, 5, 7, 8, 8, True), (1, 9, 33, 16, 8, False), (3, 17, 20, 12, 40, True),
                 (1, 35, 18, 64, 64, False), (2, 13, 21, 8, 24, False), (1, 6, 6, 4, 5, False),
                 (1, 6, 6, 4, 5, True), (2, 40, 9, 20, 16, True)]


def _styled_inputs(B, H, W, Ci, Co, up, dev, noise="batch 1", seed=0):
    """x [B,Ci,H,W] channels-last, w, s, the noise map (or None), the noise
    strength and the bias of one layer."""
    g = torch.Generator(device=dev).manual_seed(seed + H * 1000 + W + Ci + Co)
    x = torch.randn((B, Ci, H, W), generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn((Co, Ci, 3, 3), generator=g, device=dev) / math.sqrt(9 * Ci)
    s = 1 + 0.5 * torch.randn((B, Ci), generator=g, device=dev)
    f = 2 if up else 1
    nb = {"none": 0, "batch 1": 1, "batch B": B}[noise]
    nz = torch.randn((nb, 1, f * H, f * W), generator=g, device=dev) if nb else None
    nw = torch.full((1,), 0.3, device=dev)
    bias = 0.1 * torch.randn((Co,), generator=g, device=dev)
    return x, w, s, nz, nw, bias


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("H,Ci,Co,up", STYLED_SHAPES)
def test_styled_conv3_kernel_matches_plain_at_the_synthesis_shapes(card, B, H, Ci, Co, up):
    """One launch against the plain layer (cuDNN, TF32 off) at the four
    published shapes, B = 1 and 8, within 1e-4 of max |plain|; the output
    is the plain one's shape in channels-last memory."""
    args = _styled_inputs(B, H, H, Ci, Co, up, card, noise="batch B" if B == 1 else "batch 1")
    packed = sc.styled_conv_weights(args[1], up)
    before = sc.styled_conv3.launches
    got = sc.styled_conv3(*args, up=up, packed=packed)
    assert sc.styled_conv3.launches == before + 1
    want = sc.styled_conv3_plain(*args, up=up)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    _check(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", ["none", "batch B"])
@pytest.mark.parametrize("B,H,W,Ci,Co,up", STYLED_RAGGED)
def test_styled_conv3_kernel_ragged_edges(card, B, H, W, Ci, Co, up, noise):
    """H and W that overhang both tiles, a partial last N block, odd Co, a
    half K step, narrow widths, with and without noise; bit for bit across
    two calls."""
    args = _styled_inputs(B, H, W, Ci, Co, up, card, noise=noise)
    a = sc.styled_conv3(*args, up=up)
    b = sc.styled_conv3(*args, up=up)
    _check(a, sc.styled_conv3_plain(*args, up=up))
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Ci,Co,up", STYLED_SHAPES)
def test_styled_conv3_kernel_repeats_bitwise_at_the_plan(card, H, Ci, Co, up):
    """The plan's own launch at B = 1 (no split K, no atomics): two launches
    agree bit for bit."""
    args = _styled_inputs(1, H, H, Ci, Co, up, card)
    packed = sc.styled_conv_weights(args[1], up)
    a = sc.styled_conv3(*args, up=up, packed=packed)
    b = sc.styled_conv3(*args, up=up, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_styled_conv3_kernel_rejects_bad_inputs(card):
    x, w, s, nz, nw, bias = _styled_inputs(2, 8, 8, 16, 32, True, card)
    before = sc.styled_conv3.launches
    with pytest.raises(ValueError):  # the weight on the CPU
        sc.styled_conv3(x, w.cpu(), s, nz, nw, bias, up=True)
    with pytest.raises(TypeError):
        sc.styled_conv3(x.double(), w.double(), s.double(), nz, nw, bias, up=True)
    with pytest.raises(ValueError):  # noise at the input resolution
        sc.styled_conv3(x, w, s, nz[:, :, :8, :8].contiguous(), nw, bias, up=True)
    with pytest.raises(ValueError):  # packed for another layer
        sc.styled_conv3(x, w, s, nz, nw, bias, up=True,
                        packed=sc.styled_conv_weights(w, False))
    assert sc.styled_conv3.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True])
def test_styled_conv3_gradients_match_plain(card, up):
    """The gradients through ``kernel_lib.PlainGrad`` (kernel forward, plain
    backward) w.r.t. x, the weight, the style, the noise strength and the
    bias, against autograd through the plain layer; one launch."""
    args = [t.requires_grad_(t.is_floating_point()) if t is not None else t
            for t in _styled_inputs(2, 16, 16, 32, 32, up, card)]
    r = torch.randn((2, 32) + ((32, 32) if up else (16, 16)),
                    generator=torch.Generator(device=card).manual_seed(9), device=card)
    wrt = [t for t in args if t is not None]
    sc.styled_conv3.launches = 0
    got = torch.autograd.grad((sc.styled_conv3(*args, up=up) * r).sum(), wrt)
    assert sc.styled_conv3.launches == 1
    want = torch.autograd.grad((sc.styled_conv3_plain(*args, up=up) * r).sum(), wrt)
    for g, v in zip(got, want):
        _check(g, v)


@pytest.mark.cuda
def test_gpen_and_bf16_syntheses_launch_no_styled_conv(card):
    """GPEN keeps its own path: ``FaceEnhancement.process`` (unaligned and
    aligned) launches the unmasked StyledConv's kernel 0 times; so does a
    bf16 synthesis, whose unmasked layers stay on cuDNN."""
    from e4s_tpu_torch.models.gpen.face_enhancement import build_restorer
    from e4s_tpu_torch.models.gpen.rrdbnet import RRDBNet
    from e4s_tpu_torch.models.layers import init_module_
    from e4s_tpu_torch.models.stylegan2 import Generator
    from e4s_tpu_torch.pipelines.model_io import materialise

    enh = build_restorer(CHAIN_GPEN, device=card, seed=4)
    enh.srmodel = materialise(lambda: RRDBNet(scale=4, num_block=1), None, 5, card)
    img = np.kron(np.random.RandomState(3).randint(0, 256, (8, 8, 3)),
                  np.ones((8, 8, 1))).astype(np.uint8)
    sc.styled_conv3.launches = 0
    enh.process(img)
    enh.process(img, aligned=True)
    torch.cuda.synchronize()
    assert sc.styled_conv3.launches == 0
    G = init_module_(Generator(64, remaining_layer_idx=7, ch_div=8),
                     torch.Generator().manual_seed(0)).to(card)
    latent = torch.randn((2, 12, 10, 512), device=card)
    mask = torch.zeros((2, 12, 64, 64), device=card)
    mask[:, 0] = 1
    with torch.no_grad():
        G([latent], None, mask, input_is_latent=True, randomize_noise=False)
        assert sc.styled_conv3.launches == 2
        G.to(torch.bfloat16)([latent.bfloat16()], None, mask.bfloat16(),
                             input_is_latent=True, randomize_noise=False)
    assert sc.styled_conv3.launches == 2


@pytest.mark.cuda
def test_styled_conv_runs_the_plain_layer_where_a_gradient_is_taken(card):
    """With grad mode on (a training or inversion step) the unmasked
    StyledConvs run their plain version: no launch, and the generator's
    output and its gradients are those of the layers' modules."""
    from e4s_tpu_torch.models.layers import init_module_
    from e4s_tpu_torch.models.stylegan2 import Generator

    G = init_module_(Generator(64, remaining_layer_idx=7, ch_div=8),
                     torch.Generator().manual_seed(0)).to(card)
    latent = torch.randn((2, 12, 10, 512), device=card, requires_grad=True)
    mask = torch.zeros((2, 12, 64, 64), device=card)
    mask[:, 0] = 1
    sc.styled_conv3.launches = 0
    img = G([latent], None, mask, input_is_latent=True, randomize_noise=False)[0]
    assert sc.styled_conv3.launches == 0
    with torch.no_grad():
        fast = G([latent], None, mask, input_is_latent=True, randomize_noise=False)[0]
    assert sc.styled_conv3.launches == 2
    _check(fast, img.detach())
    img.square().mean().backward()
    assert latent.grad is not None and torch.isfinite(latent.grad).all()


@pytest.mark.cuda
def test_styled_conv_runs_the_plain_layer_under_the_edits_full_channel_noise(card):
    """The edit's and the demo's fixed noise has a map per channel
    ([1,C,r,r]); the kernel adds one map a pixel, so those layers run the
    plain version (no launch), and the same noise's first channel runs
    the kernel, each against the plain composition."""
    from e4s_tpu_torch.models.layers import init_module_
    from e4s_tpu_torch.models.stylegan2 import Generator
    from e4s_tpu_torch.pipelines.face_edit import sample_fixed_noise

    G = init_module_(Generator(64, remaining_layer_idx=7),
                     torch.Generator().manual_seed(0)).to(card)
    latent = torch.randn((2, 12, 10, 512), device=card)
    mask = torch.zeros((2, 12, 64, 64), device=card)
    mask[:, 0] = 1
    full = [n.to(card) for n in sample_fixed_noise(64)]
    with torch.no_grad():
        for noise, launches in ((full, 0), ([n[:, :1].contiguous() for n in full], 2)):
            sc.styled_conv3.launches = 0
            img = G([latent], None, mask, input_is_latent=True, randomize_noise=False,
                    noise=noise)[0]
            assert sc.styled_conv3.launches == launches
            with torch.enable_grad():  # grad mode on: the plain layers
                want = G([latent], None, mask, input_is_latent=True,
                         randomize_noise=False, noise=noise)[0]
            assert sc.styled_conv3.launches == launches
            _check(img, want.detach())
