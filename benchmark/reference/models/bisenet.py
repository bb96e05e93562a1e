"""BiSeNet face parser (19 classes, face-parsing.PyTorch) and its input
normalisation. Module names follow the reference, so its
``79999_iter.pth`` loads with ``load_state_dict``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.encoders import FrozenBatchNorm
from benchmark.reference.ops.resize import bilinear_resize, nearest_resize

SEG_MEAN = (0.485, 0.456, 0.406)
SEG_STD = (0.229, 0.224, 0.225)


def _conv(i, o, k, s=1, p=0):
    return nn.Conv2d(i, o, k, s, p, bias=False)


class ConvBNReLU(nn.Module):
    def __init__(self, in_chan, out_chan, ks=3, stride=1, padding=1):
        super().__init__()
        self.conv = _conv(in_chan, out_chan, ks, stride, padding)
        self.bn = FrozenBatchNorm(out_chan)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BiSeNetOutput(nn.Module):
    def __init__(self, in_chan, mid_chan, n_classes):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan)
        self.conv_out = _conv(mid_chan, n_classes, 1)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class AttentionRefinementModule(nn.Module):
    def __init__(self, in_chan, out_chan):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, out_chan)
        self.conv_atten = _conv(out_chan, out_chan, 1)
        self.bn_atten = FrozenBatchNorm(out_chan)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(-2, -1), keepdim=True)))
        return feat * torch.sigmoid(atten)


class BasicBlock(nn.Module):
    def __init__(self, in_chan, out_chan, stride=1):
        super().__init__()
        self.conv1 = _conv(in_chan, out_chan, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(out_chan)
        self.conv2 = _conv(out_chan, out_chan, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(out_chan)
        self.downsample = None
        if in_chan != out_chan or stride != 1:
            self.downsample = nn.Sequential(
                _conv(in_chan, out_chan, 1, stride), FrozenBatchNorm(out_chan)
            )

    def forward(self, x):
        res = F.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(shortcut + res)


class Resnet18(nn.Module):
    """Returns (feat8, feat16, feat32)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        chans = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        for n, (i, o, s) in enumerate(chans, start=1):
            setattr(self, f"layer{n}",
                    nn.Sequential(BasicBlock(i, o, s), BasicBlock(o, o, 1)))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer1(x)
        feat8 = self.layer2(x)
        feat16 = self.layer3(feat8)
        feat32 = self.layer4(feat16)
        return feat8, feat16, feat32


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(-2, -1), keepdim=True))
        feat32_sum = self.arm32(feat32) + avg
        feat32_up = self.conv_head32(nearest_resize(feat32_sum, feat16.shape[-2:]))
        feat16_sum = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(nearest_resize(feat16_sum, feat8.shape[-2:]))
        return feat8, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, in_chan=256, out_chan=256):
        super().__init__()
        self.convblk = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)
        self.conv1 = _conv(out_chan, out_chan // 4, 1)
        self.conv2 = _conv(out_chan // 4, out_chan, 1)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(-2, -1), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class BiSeNet(nn.Module):
    """forward(x [B,3,H,W]) -> (out, out16, out32) logits at input size."""

    def __init__(self, n_classes=19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x):
        H, W = x.shape[-2:]
        feat_res8, feat_cp8, feat_cp16 = self.cp(x)
        feat_fuse = self.ffm(feat_res8, feat_cp8)
        outs = (self.conv_out(feat_fuse), self.conv_out16(feat_cp8),
                self.conv_out32(feat_cp16))
        return tuple(bilinear_resize(o, (H, W), align_corners=True)
                     for o in outs)


@functools.lru_cache(maxsize=None)
def _bicubic_taps(factor: int, dtype: torch.dtype, device: torch.device):
    """The 1-D taps as a tensor on ``device``, made once per factor."""
    return torch.as_tensor(_bicubic_kernel_1d(factor), dtype=dtype, device=device)


def _bicubic_kernel_1d(factor: int, a: float = -0.5) -> np.ndarray:
    size = factor * 4

    def k(x):
        ax = abs(x)
        if ax <= 1.0:
            return (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
        if ax < 2.0:
            return a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
        return 0.0

    taps = np.array(
        [k((i - math.floor(size / 2) + 0.5) / factor) for i in range(size)],
        dtype=np.float32,
    )
    return taps / taps.sum()


def bicubic_downsample(x, factor: int, clip_round: bool = False):
    """Separable bicubic FIR downsample with reflect padding (the
    reference's BicubicDownSample). x: [B,C,H,W]."""
    if factor == 1:
        return x
    C = x.shape[1]
    size = factor * 4
    pad = size - factor
    pad0, pad1 = pad // 2, pad - pad // 2
    taps = _bicubic_taps(factor, x.dtype, x.device)
    x = F.pad(x, (0, 0, pad0, pad1), mode="reflect")
    x = F.conv2d(x, taps.reshape(1, 1, size, 1).expand(C, 1, size, 1),
                 stride=(factor, 1), groups=C)
    if clip_round:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    x = F.pad(x, (pad0, pad1, 0, 0), mode="reflect")
    x = F.conv2d(x, taps.reshape(1, 1, 1, size).expand(C, 1, 1, size),
                 stride=(1, factor), groups=C)
    if clip_round:
        x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x


@functools.lru_cache(maxsize=None)
def _norm_consts(dtype: torch.dtype, device: torch.device):
    """SEG_MEAN and SEG_STD as [1,3,1,1] tensors on ``device``, made once
    (not a host-to-device copy per request)."""
    return tuple(torch.tensor(v, dtype=dtype, device=device).reshape(1, 3, 1, 1)
                 for v in (SEG_MEAN, SEG_STD))


def parser_input(img01, parser_size: int = 512):
    """[B,3,S,S] in [0,1] -> the normalised [B,3,ps,ps] BiSeNet input."""
    if img01.shape[-1] >= parser_size:
        im = bicubic_downsample(img01, img01.shape[-1] // parser_size)
    else:
        im = bilinear_resize(img01, (parser_size, parser_size))
    im = torch.clamp(im, 0.0, 1.0)
    mean, std = _norm_consts(im.dtype, im.device)
    return (im - mean) / std


