"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips when no GPU is present
(decided inside the test). On a GPU machine (``--noconftest``: the suite's
conftest imports JAX, which a GPU machine for the port need not have):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: max |kernel - plain| <= 1e-4 * max |plain| in f32 with TF32 off;
the sums run over up to 9 * 512 terms in another order.
"""

import math
import types

import numpy as np
import pytest
import torch

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


def _check(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item()


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
