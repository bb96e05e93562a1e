"""SegNeXt face parser: MSCAN backbone + LightHamHead with the NMF Hamburger
(counterpart of ``e4s_tpu/models/segnext.py``). Submodules are named as in
the mmseg checkpoint, so an mmseg ``.pth`` loads with ``load_state_dict``.

The arithmetic is the JAX package's, also where it is not mmseg's: GELU is
the tanh approximation (``jax.nn.gelu``'s default), and the NMF bases are
the JAX package's fixed draw (``jax.random.uniform(PRNGKey(0), (1,C,16))``,
normalised over C), which torch cannot reproduce: they ship as a constant,
``segnext_bases.npz``, for C in {256, 512, 1024}.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from e4s_tpu_torch.models.encoders import FrozenBatchNorm
from e4s_tpu_torch.ops.resize import bilinear_resize

SEGNEXT_VARIANTS = {
    "tiny": dict(embed_dims=(32, 64, 160, 256), depths=(3, 3, 5, 2),
                 mlp_ratios=(8, 8, 4, 4), head_in=(64, 160, 256), ham_channels=256),
    "small": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 4, 2),
                  mlp_ratios=(8, 8, 4, 4), head_in=(128, 320, 512), ham_channels=256),
    "base": dict(embed_dims=(64, 128, 320, 512), depths=(3, 3, 12, 3),
                 mlp_ratios=(8, 8, 4, 4), head_in=(128, 320, 512), ham_channels=512),
    "large": dict(embed_dims=(64, 128, 320, 512), depths=(3, 5, 27, 3),
                  mlp_ratios=(8, 8, 4, 4), head_in=(128, 320, 512), ham_channels=1024),
}

# mmseg input normalisation of the SegNeXt configs (0-255 scale)
SEGNEXT_MEAN = (123.675, 116.28, 103.53)
SEGNEXT_STD = (58.395, 57.12, 57.375)

BASES_FILE = Path(__file__).resolve().parent / "segnext_bases.npz"


@functools.lru_cache(maxsize=None)
def nmf_bases(channels: int) -> np.ndarray:
    """The JAX package's NMF start for ``channels`` rows: [1, C, 16] f32."""
    with np.load(BASES_FILE) as z:
        return z[f"c{channels}"]


def gelu(x):
    return F.gelu(x, approximate="tanh")


class DWConv(nn.Conv2d):
    """Depthwise (kh, kw) conv with bias and same padding."""

    def __init__(self, channels, kh, kw):
        super().__init__(channels, channels, (kh, kw),
                         padding=(kh // 2, kw // 2), groups=channels)


class MSCAAttention(nn.Module):
    """Multi-scale convolutional attention: a 5x5 depthwise conv, strip
    convs of 7, 11 and 21, a 1x1 mix, times the input."""

    def __init__(self, dim):
        super().__init__()
        self.conv0 = DWConv(dim, 5, 5)
        self.conv0_1, self.conv0_2 = DWConv(dim, 1, 7), DWConv(dim, 7, 1)
        self.conv1_1, self.conv1_2 = DWConv(dim, 1, 11), DWConv(dim, 11, 1)
        self.conv2_1, self.conv2_2 = DWConv(dim, 1, 21), DWConv(dim, 21, 1)
        self.conv3 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        attn = self.conv0(x)
        attn = (attn + self.conv0_2(self.conv0_1(attn))
                + self.conv1_2(self.conv1_1(attn))
                + self.conv2_2(self.conv2_1(attn)))
        return self.conv3(attn) * x


class _Attention(nn.Module):
    """mmseg's ``attn``: proj_1, GELU, spatial gating, proj_2 (without the
    inner shortcut, as the JAX package computes it)."""

    def __init__(self, dim):
        super().__init__()
        self.proj_1 = nn.Conv2d(dim, dim, 1)
        self.spatial_gating_unit = MSCAAttention(dim)
        self.proj_2 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        return self.proj_2(self.spatial_gating_unit(gelu(self.proj_1(x))))


class _MlpDWConv(nn.Module):
    """mmseg's ``mlp.dwconv``: a 3x3 depthwise conv named ``dwconv``."""

    def __init__(self, dim):
        super().__init__()
        self.dwconv = DWConv(dim, 3, 3)

    def forward(self, x):
        return self.dwconv(x)


class _Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dwconv = _MlpDWConv(hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(gelu(self.dwconv(self.fc1(x))))


class MSCABlock(nn.Module):
    def __init__(self, dim, mlp_ratio):
        super().__init__()
        self.layer_scale_1 = nn.Parameter(torch.empty(dim))
        self.layer_scale_2 = nn.Parameter(torch.empty(dim))
        self.norm1 = FrozenBatchNorm(dim)
        self.attn = _Attention(dim)
        self.norm2 = FrozenBatchNorm(dim)
        self.mlp = _Mlp(dim, dim * mlp_ratio)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.layer_scale_1.fill_(1e-2)
            self.layer_scale_2.fill_(1e-2)

    def forward(self, x):
        x = x + self.layer_scale_1[:, None, None] * self.attn(self.norm1(x))
        return x + self.layer_scale_2[:, None, None] * self.mlp(self.norm2(x))


class _StemConv(nn.Module):
    """``patch_embed1.proj``: conv s2, BN, GELU, conv s2, BN (total /4)."""

    def __init__(self, dim):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Conv2d(3, dim // 2, 3, 2, 1), FrozenBatchNorm(dim // 2),
            nn.GELU(approximate="tanh"),
            nn.Conv2d(dim // 2, dim, 3, 2, 1), FrozenBatchNorm(dim),
        )

    def forward(self, x):
        return self.proj(x)


class _PatchEmbed(nn.Module):
    def __init__(self, in_dim, dim):
        super().__init__()
        self.proj = nn.Conv2d(in_dim, dim, 3, 2, 1)
        self.norm = FrozenBatchNorm(dim)

    def forward(self, x):
        return self.norm(self.proj(x))


class MSCAN(nn.Module):
    """4-stage hierarchical backbone; returns the 4 stage feature maps (each
    closed by a LayerNorm over the channels)."""

    def __init__(self, embed_dims=(64, 128, 320, 512), depths=(2, 2, 4, 2),
                 mlp_ratios=(8, 8, 4, 4)):
        super().__init__()
        for s, (dim, depth, ratio) in enumerate(
                zip(embed_dims, depths, mlp_ratios), start=1):
            embed = _StemConv(dim) if s == 1 else _PatchEmbed(embed_dims[s - 2], dim)
            setattr(self, f"patch_embed{s}", embed)
            setattr(self, f"block{s}", nn.ModuleList(
                [MSCABlock(dim, ratio) for _ in range(depth)]))
            setattr(self, f"norm{s}", nn.LayerNorm(dim, eps=1e-5))

    def forward(self, x):
        feats = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x)
            x = getattr(self, f"norm{s}")(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            feats.append(x)
        return feats


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with 32 groups, eps 1e-5 (population variance)."""

    def __init__(self, channels, groups: int = 32):
        super().__init__(groups, channels, eps=1e-5)


class ConvModule(nn.Module):
    """mmcv ConvModule as the head uses it: 1x1 conv without bias, GroupNorm
    (key ``gn``), optional ReLU."""

    def __init__(self, in_ch, out_ch, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.gn = GroupNorm32(out_ch)
        self.act = act

    def forward(self, x):
        x = self.gn(self.conv(x))
        return F.relu(x) if self.act else x


def nmf2d(x, bases, eval_steps: int = 7, eps: float = 1e-6):
    """Multiplicative-update NMF. x [B,C,N] >= 0, bases [B,C,R] -> the rank-R
    reconstruction bases @ coef^T [B,C,N]. The start, softmax(100 x^T B),
    amplifies small differences of x."""
    xt = x.transpose(1, 2)
    coef = torch.softmax(100.0 * torch.bmm(xt, bases), dim=-1)

    def update_coef(bases, coef):
        num = torch.bmm(xt, bases)
        den = torch.bmm(coef, torch.bmm(bases.transpose(1, 2), bases))
        return coef * num / (den + eps)

    for _ in range(eval_steps):
        coef = update_coef(bases, coef)
        num = torch.bmm(x, coef)
        den = torch.bmm(bases, torch.bmm(coef.transpose(1, 2), coef))
        bases = bases * num / (den + eps)
    coef = update_coef(bases, coef)
    return torch.bmm(bases, coef.transpose(1, 2))


class _HamIn(nn.Module):
    """``ham_in``: a ConvModule without norm, i.e. a biased 1x1 conv."""

    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        return self.conv(x)


class Hamburger(nn.Module):
    def __init__(self, ham_channels: int = 256, md_r: int = 16):
        super().__init__()
        self.ham_in = _HamIn(ham_channels)
        self.ham_out = ConvModule(ham_channels, ham_channels, act=False)
        self.md_r = md_r
        self.register_buffer("bases", torch.empty(1, ham_channels, md_r),
                             persistent=False)

    def load_constants(self):
        """Fill the non-persistent NMF bases from the packaged constant (a
        checkpoint does not carry them)."""
        self.bases = torch.from_numpy(nmf_bases(self.bases.shape[1]).copy())

    def forward(self, x):
        enjoy = F.relu(self.ham_in(x))
        B, C, H, W = enjoy.shape
        bases = self.bases.to(enjoy.dtype).expand(B, C, self.md_r)
        recon = nmf2d(enjoy.reshape(B, C, H * W), bases).reshape(B, C, H, W)
        return F.relu(x + self.ham_out(recon))


class LightHamHead(nn.Module):
    """Stages 2-4 resized to stage 2, concatenated, squeezed, Hamburger,
    aligned, classified."""

    def __init__(self, in_channels, num_classes=19, channels=256,
                 ham_channels=256, md_r=16):
        super().__init__()
        self.squeeze = ConvModule(sum(in_channels), ham_channels)
        self.hamburger = Hamburger(ham_channels, md_r)
        self.align = ConvModule(ham_channels, channels)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        hw = feats[1].shape[-2:]
        x = torch.cat([bilinear_resize(f, hw) for f in feats[1:]], dim=1)
        x = self.hamburger(self.squeeze(x))
        return self.conv_seg(self.align(x))


class SegNeXt(nn.Module):
    """Whole-image encoder-decoder; logits upsampled to the input size."""

    def __init__(self, variant: str = "small", num_classes: int = 19):
        super().__init__()
        cfg = SEGNEXT_VARIANTS[variant]
        self.variant = variant
        self.backbone = MSCAN(cfg["embed_dims"], cfg["depths"], cfg["mlp_ratios"])
        self.decode_head = LightHamHead(cfg["embed_dims"][1:], num_classes, 256,
                                        cfg["ham_channels"])

    def forward(self, x):
        logits = self.decode_head(self.backbone(x))
        return bilinear_resize(logits, x.shape[-2:])


@functools.lru_cache(maxsize=None)
def _norm_consts(dtype: torch.dtype, device: torch.device):
    """SEGNEXT_MEAN and SEGNEXT_STD as [1,3,1,1] tensors on ``device``, made
    once (not a host-to-device copy per request)."""
    return tuple(torch.tensor(v, dtype=dtype, device=device).reshape(1, 3, 1, 1)
                 for v in (SEGNEXT_MEAN, SEGNEXT_STD))


def segnext_parse19_device(model, img01, size: int = 512):
    """[B,3,S,S] in [0,1] -> int64 19-class labels [B,size,size] in the
    CelebA taxonomy."""
    x = bilinear_resize(img01, (size, size)) * 255.0
    mean, std = _norm_consts(x.dtype, x.device)
    return model((x - mean) / std).argmax(dim=1)


class SegNeXtFaceParser:
    """Host-facing wrapper with FaceParser's interface: __call__(img01) ->
    [B,parser_size,parser_size] int64 CelebA-taxonomy labels. ``model`` is
    a SegNeXt already on its device."""

    taxonomy = "celeba19"

    def __init__(self, model: SegNeXt, parser_size: int = 512):
        self.model = model
        self.parser_size = parser_size

    @torch.no_grad()
    def __call__(self, img01):
        return segnext_parse19_device(self.model, img01, self.parser_size)
