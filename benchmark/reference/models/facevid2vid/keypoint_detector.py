"""Canonical 3-D keypoint detector and head-pose/expression estimator
(vox-256: 15 keypoints, no jacobians, scale factor 0.25)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.encoders import FrozenBatchNorm
from benchmark.reference.models.facevid2vid.util import (
    AntiAliasInterpolation2d,
    KPHourglass,
    ResBottleneck,
    make_coordinate_grid_3d,
)


class KPDetector(nn.Module):
    """forward(x [B,3,S,S] in [0,1]) -> {"value": [B, num_kp, 3]}."""

    def __init__(self, block_expansion=32, num_kp=15, image_channel=3,
                 max_features=1024, reshape_channel=16384, reshape_depth=16,
                 num_blocks=5, temperature=0.1, scale_factor=0.25):
        super().__init__()
        self.predictor = KPHourglass(
            block_expansion, in_features=image_channel,
            reshape_features=reshape_channel, reshape_depth=reshape_depth,
            num_blocks=num_blocks, max_features=max_features)
        self.kp = nn.Conv3d(self.predictor.up_blocks[-1].conv.out_channels,
                            num_kp, 3, padding=1)
        self.temperature = temperature
        self.scale_factor = scale_factor
        if scale_factor != 1:
            self.down = AntiAliasInterpolation2d(image_channel, scale_factor)

    def forward(self, x):
        if self.scale_factor != 1:
            x = self.down(x)
        prediction = self.kp(self.predictor(x))
        B, K, D, H, W = prediction.shape
        heatmap = F.softmax(prediction.reshape(B, K, -1) / self.temperature,
                            dim=2).reshape(B, K, D, H, W)
        grid = make_coordinate_grid_3d(D, H, W, heatmap.dtype, heatmap.device)
        return {"value": torch.einsum("bkdhw,dhwc->bkc", heatmap, grid)}


def _bottlenecks(tag, n, features):
    seq = nn.Sequential()
    for i in range(n):
        seq.add_module(f"b{tag}_{i}", ResBottleneck(features, 1))
    return seq


class HEEstimator(nn.Module):
    """Head pose (66 yaw/pitch/roll bins), translation and expression.
    The reference's forward reads its yaw from ``fc_roll`` and its roll from
    ``fc_yaw``; its weights are trained so, and that is kept."""

    def __init__(self, block_expansion=64, num_kp=15, image_channel=3,
                 max_features=2048, num_bins=66):
        super().__init__()
        be = block_expansion
        self.conv1 = nn.Conv2d(image_channel, be, 7, stride=2, padding=3)
        self.norm1 = FrozenBatchNorm(be)
        self.conv2 = nn.Conv2d(be, 256, 1)
        self.norm2 = FrozenBatchNorm(256)
        self.block1 = _bottlenecks(1, 3, 256)
        self.conv3 = nn.Conv2d(256, 512, 1)
        self.norm3 = FrozenBatchNorm(512)
        self.block2 = ResBottleneck(512, 2)
        self.block3 = _bottlenecks(3, 3, 512)
        self.conv4 = nn.Conv2d(512, 1024, 1)
        self.norm4 = FrozenBatchNorm(1024)
        self.block4 = ResBottleneck(1024, 2)
        self.block5 = _bottlenecks(5, 5, 1024)
        self.conv5 = nn.Conv2d(1024, 2048, 1)
        self.norm5 = FrozenBatchNorm(2048)
        self.block6 = ResBottleneck(2048, 2)
        self.block7 = _bottlenecks(7, 2, 2048)
        self.fc_roll = nn.Linear(2048, num_bins)
        self.fc_pitch = nn.Linear(2048, num_bins)
        self.fc_yaw = nn.Linear(2048, num_bins)
        self.fc_t = nn.Linear(2048, 3)
        self.fc_exp = nn.Linear(2048, 3 * num_kp)

    def forward(self, x):
        out = F.relu(self.norm1(self.conv1(x)))
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        out = self.block1(F.relu(self.norm2(self.conv2(out))))
        out = F.relu(self.norm3(self.conv3(out)))
        out = self.block3(self.block2(out))
        out = F.relu(self.norm4(self.conv4(out)))
        out = self.block5(self.block4(out))
        out = F.relu(self.norm5(self.conv5(out)))
        out = self.block7(self.block6(out))
        out = out.mean(dim=(-2, -1))
        return {"yaw": self.fc_roll(out), "pitch": self.fc_pitch(out),
                "roll": self.fc_yaw(out), "t": self.fc_t(out),
                "exp": self.fc_exp(out)}
