"""RRDBNet, the RealESRNet super-resolution trunk (32 features, 23 blocks)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def pixel_unshuffle(x, scale: int):
    """Space-to-depth: [B,C,H,W] -> [B,C*scale^2,H/scale,W/scale]."""
    return F.pixel_unshuffle(x, scale)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat=32, num_grow_ch=32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", nn.Conv2d(
                num_feat + i * num_grow_ch, num_grow_ch, 3, 1, 1))
        self.conv5 = nn.Conv2d(num_feat + 4 * num_grow_ch, num_feat, 3, 1, 1)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            feats.append(_lrelu(getattr(self, f"conv{i + 1}")(torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat=32, num_grow_ch=32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """forward(x [B,3,H,W] in [0,1]) -> [B,3,H*scale/..,..]: x4 for scale 4
    (scale 2 and 1 first pixel-unshuffle by 2 and 4)."""

    def __init__(self, num_in_ch=3, num_out_ch=3, scale=4, num_feat=32,
                 num_block=23, num_grow_ch=32):
        super().__init__()
        self.scale = scale
        in_ch = num_in_ch * {2: 4, 1: 16}.get(scale, 1)
        self.conv_first = nn.Conv2d(in_ch, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        for conv in (self.conv_up1, self.conv_up2):
            feat = _lrelu(conv(feat.repeat_interleave(2, -2).repeat_interleave(2, -1)))
        return self.conv_last(_lrelu(self.conv_hr(feat)))
