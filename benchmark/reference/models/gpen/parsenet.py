"""ParseNet, GPEN's 19-class face parser for its paste-back mask
(512 in and out,
min feature 32, base 64, channels 32-256, BatchNorm, LeakyReLU)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.encoders import FrozenBatchNorm


class _NormWrap(nn.Module):
    """The reference's NormLayer: the BatchNorm sits at ``norm.norm``."""

    def __init__(self, channels):
        super().__init__()
        self.norm = FrozenBatchNorm(channels)

    def forward(self, x):
        return self.norm(x)


class PNConvLayer(nn.Module):
    """[nearest 2x up] -> reflection pad -> conv (stride 2 for "down")
    [-> BN] [-> LeakyReLU 0.2]."""

    def __init__(self, in_channels, out_channels, kernel_size=3, scale="none",
                 norm=False, relu=False):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.pad = int(math.ceil((kernel_size - 1.0) / 2))
        self.conv2d = nn.Conv2d(in_channels, out_channels, kernel_size,
                                2 if scale == "down" else 1, bias=not norm)
        self.norm = _NormWrap(out_channels) if norm else None

    def forward(self, x):
        if self.scale == "up":
            x = x.repeat_interleave(2, -2).repeat_interleave(2, -1)
        x = self.conv2d(F.pad(x, (self.pad,) * 4, mode="reflect"))
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, 0.2) if self.relu else x


class PNResidualBlock(nn.Module):
    def __init__(self, c_in, c_out, scale="none"):
        super().__init__()
        self.shortcut_func = (None if scale == "none" and c_in == c_out
                              else PNConvLayer(c_in, c_out, 3, scale))
        first, second = {"down": ("none", "down"), "up": ("up", "none"),
                         "none": ("none", "none")}[scale]
        self.conv1 = PNConvLayer(c_in, c_out, 3, first, norm=True, relu=True)
        self.conv2 = PNConvLayer(c_out, c_out, 3, second, norm=True)

    def forward(self, x):
        identity = x if self.shortcut_func is None else self.shortcut_func(x)
        return identity + self.conv2(self.conv1(x))


class ParseNet(nn.Module):
    """forward(x [B,3,S,S] in [-1,1]) -> (mask logits [B,19,S,S],
    image [B,3,S,S])."""

    def __init__(self, in_size=512, out_size=512, min_feat_size=32, base_ch=64,
                 parsing_ch=19, res_depth=10, min_ch=32, max_ch=256):
        super().__init__()

        def clip(c):
            return max(min_ch, min(c, max_ch))

        self.in_size = in_size
        mfs = min(in_size, min_feat_size)
        down_steps = int(np.log2(in_size // mfs))
        up_steps = int(np.log2(out_size // mfs))
        enc = [PNConvLayer(3, base_ch, 3)]
        head = base_ch
        for _ in range(down_steps):
            enc.append(PNResidualBlock(clip(head), clip(head * 2), "down"))
            head *= 2
        self.encoder = nn.Sequential(*enc)
        self.body = nn.Sequential(*[PNResidualBlock(clip(head), clip(head))
                                    for _ in range(res_depth)])
        dec = []
        for _ in range(up_steps):
            dec.append(PNResidualBlock(clip(head), clip(head // 2), "up"))
            head //= 2
        self.decoder = nn.Sequential(*dec)
        self.out_img_conv = PNConvLayer(clip(head), 3)
        self.out_mask_conv = PNConvLayer(clip(head), parsing_ch)

    def forward(self, x):
        feat = self.encoder(x)
        out = self.decoder(feat + self.body(feat))
        return self.out_mask_conv(out), self.out_img_conv(out)


# binary paste-back colormap over the 19 labels
MASK_COLORMAP = [0, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
                 255, 255, 0, 255, 255, 255, 0]


@functools.lru_cache(maxsize=None)
def _mask_lut(device: torch.device):
    return torch.tensor(MASK_COLORMAP, dtype=torch.float32, device=device)


def parse_mask(logits):
    """argmax over the 19 classes -> the paste mask in {0, 255}, float32."""
    return _mask_lut(logits.device)[logits.argmax(dim=1)]
