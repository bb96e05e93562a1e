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

# (input H=W, Ci, Co) of every patch-modulated conv on the 1024^2 main path
MAIN_PATH_SHAPES = [
    (4, 512, 512), (8, 512, 512), (16, 512, 512), (32, 512, 512),
    (64, 512, 512), (64, 512, 256), (128, 256, 256), (128, 256, 128),
    (256, 128, 128),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _inputs(H, Ci, Co, dev, B=1, W=None):
    g = torch.Generator(device=dev).manual_seed(H * 1000 + Ci + Co)
    W = W or H
    x = torch.randn((B, H, W, Ci), generator=g, device=dev)
    w = torch.randn((Co, Ci, 3, 3), generator=g, device=dev) / math.sqrt(9 * Ci)
    smap = 1 + 0.5 * torch.randn((B, H, W, Ci), generator=g, device=dev)
    dmap = 0.5 + torch.rand((B, H, W, Co), generator=g, device=dev)
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
@pytest.mark.parametrize("B,H,W,Ci,Co", [(2, 5, 7, 24, 40), (1, 9, 130, 16, 8)])
def test_patch_mod_conv3_kernel_ragged_edges(card, B, H, W, Ci, Co):
    """Tiles that overhang H, W, Ci and Co; no dmap."""
    x, w, smap, _ = _inputs(H, Ci, Co, card, B=B, W=W)
    got = pmc.patch_mod_conv3_nhwc(x, w, smap, None)
    _check(got, pmc.patch_mod_conv3_nhwc_plain(x, w, smap, None))


@pytest.mark.cuda
def test_patch_mod_conv3_kernel_rejects_bad_inputs(card):
    x, w, smap, dmap = _inputs(8, 16, 16, card)
    with pytest.raises(ValueError):
        pmc.patch_mod_conv3_nhwc(x.transpose(1, 2), w, smap, dmap)
    with pytest.raises(TypeError):
        pmc.patch_mod_conv3_nhwc(x.double(), w, smap.double(), dmap)


@pytest.mark.cuda
def test_swap_on_the_card_matches_the_cpu(card):
    """A small seeded swapper (64^2, K=7: 16 masked-conv launches) on the
    card and on the CPU, where the kernel's plain version runs instead."""
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
        assert pmc.patch_mod_conv3_nhwc.launches == (16 if dev == "cuda" else 0)
    mse = np.mean((out["cuda"] - out["cpu"]) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 40.0
