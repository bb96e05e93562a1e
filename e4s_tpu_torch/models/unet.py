"""19-class face-parsing U-Net of the parsing loss (frozen; counterpart of
``e4s_tpu/models/unet.py``). feature_scale 4: filters 16, 32, 64, 128, 256.
Keys are the reference checkpoint's (``conv1.conv1.{0,1}``,
``up_concat4.up``, ``up_concat4.conv.conv2.1``, ``final``...).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from e4s_tpu_torch.models.encoders import FrozenBatchNorm, l2_normalize


class UnetConv2(nn.Module):
    """(conv 3x3, BatchNorm, ReLU) twice."""

    def __init__(self, in_size, out_size):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(in_size, out_size, 3, 1, 1),
                                   FrozenBatchNorm(out_size), nn.ReLU())
        self.conv2 = nn.Sequential(nn.Conv2d(out_size, out_size, 3, 1, 1),
                                   FrozenBatchNorm(out_size), nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UnetUp(nn.Module):
    """2x up (transposed conv, kernel 2, stride 2), concatenated after the
    skip, then ``UnetConv2``."""

    def __init__(self, in_size, out_size):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_size, out_size, 2, stride=2)
        self.conv = UnetConv2(in_size, out_size)

    def forward(self, skip, x):
        return self.conv(torch.cat([skip, self.up(x)], dim=1))


class ParsingUNet(nn.Module):
    """forward(x [B,3,H,W]) -> 19-class logits; with ``extract_feats_only``
    the five encoder outputs (conv1..conv4, center), each flattened and
    l2-normalised (what the parsing loss compares)."""

    def __init__(self, feature_scale: int = 4, n_classes: int = 19):
        super().__init__()
        f = [int(c / feature_scale) for c in (64, 128, 256, 512, 1024)]
        self.conv1 = UnetConv2(3, f[0])
        self.conv2 = UnetConv2(f[0], f[1])
        self.conv3 = UnetConv2(f[1], f[2])
        self.conv4 = UnetConv2(f[2], f[3])
        self.center = UnetConv2(f[3], f[4])
        self.up_concat4 = UnetUp(f[4], f[3])
        self.up_concat3 = UnetUp(f[3], f[2])
        self.up_concat2 = UnetUp(f[2], f[1])
        self.up_concat1 = UnetUp(f[1], f[0])
        self.final = nn.Conv2d(f[0], n_classes, 1)

    def forward(self, x, extract_feats_only: bool = False):
        conv1 = self.conv1(x)
        conv2 = self.conv2(F.max_pool2d(conv1, 2))
        conv3 = self.conv3(F.max_pool2d(conv2, 2))
        conv4 = self.conv4(F.max_pool2d(conv3, 2))
        center = self.center(F.max_pool2d(conv4, 2))
        if extract_feats_only:
            return [l2_normalize(t.reshape(x.shape[0], -1))
                    for t in (conv1, conv2, conv3, conv4, center)]
        up = self.up_concat4(conv4, center)
        up = self.up_concat3(conv3, up)
        up = self.up_concat2(conv2, up)
        return self.final(self.up_concat1(conv1, up))
