"""Occlusion-aware SPADE generator, the one E4S drives."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.facevid2vid.dense_motion import DenseMotionNetwork
from benchmark.reference.models.facevid2vid.util import (
    DownBlock2d,
    ResBlock3d,
    SameBlock2d,
    SPADEResnetBlock,
)
from benchmark.reference.ops.resize import bilinear_resize
from benchmark.reference.ops.warp import grid_sample_3d


def _up2(x):
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)


class SPADEDecoder(nn.Module):
    """Its widths are fixed (256 in, 64 out, label channels 256)."""

    def __init__(self):
        super().__init__()
        ic, oc, label_nc = 256, 64, 256
        self.fc = nn.Conv2d(ic, 2 * ic, 3, padding=1)
        for i in range(6):
            setattr(self, f"G_middle_{i}",
                    SPADEResnetBlock(2 * ic, 2 * ic, label_nc))
        self.up_0 = SPADEResnetBlock(2 * ic, ic, label_nc)
        self.up_1 = SPADEResnetBlock(ic, oc, label_nc)
        self.conv_img = nn.Conv2d(oc, 3, 3, padding=1)

    def forward(self, feature):
        seg = feature
        x = self.fc(feature)
        for i in range(6):
            x = getattr(self, f"G_middle_{i}")(x, seg)
        x = self.up_0(_up2(x), seg)
        x = self.up_1(_up2(x), seg)
        return torch.sigmoid(self.conv_img(F.leaky_relu(x, 0.2)))


class OcclusionAwareSPADEGenerator(nn.Module):
    """vox-256: block 64, max 512, 2 down blocks, reshape 32 x 16,
    6 3-D res blocks, occlusion on. forward(source [B,3,S,S] in [0,1],
    kp_driving, kp_source) -> {"mask", "occlusion_map", "prediction"}."""

    def __init__(self, image_channel=3, feature_channel=32, num_kp=15,
                 block_expansion=64, max_features=512, num_down_blocks=2,
                 reshape_channel=32, reshape_depth=16, num_resblocks=6,
                 estimate_occlusion_map=True, dense_motion_params=None):
        super().__init__()
        self.dense_motion_network = DenseMotionNetwork(
            num_kp=num_kp, feature_channel=feature_channel,
            reshape_depth=reshape_depth,
            estimate_occlusion_map=estimate_occlusion_map,
            **(dense_motion_params or {}))
        self.first = SameBlock2d(image_channel, block_expansion)
        self.down_blocks = nn.ModuleList()
        in_f = block_expansion
        for i in range(num_down_blocks):
            out_f = min(max_features, block_expansion * 2 ** (i + 1))
            self.down_blocks.append(DownBlock2d(in_f, out_f))
            in_f = out_f
        self.second = nn.Conv2d(in_f, max_features, 1)
        self.resblocks_3d = nn.Sequential()
        for i in range(num_resblocks):
            self.resblocks_3d.add_module(f"3dr{i}", ResBlock3d(reshape_channel))
        out_f = block_expansion * 2 ** num_down_blocks
        self.third = SameBlock2d(max_features, out_f, lrelu=True)
        self.fourth = nn.Conv2d(out_f, out_f, 1)
        self.decoder = SPADEDecoder()
        self.reshape_channel = reshape_channel
        self.reshape_depth = reshape_depth

    def forward(self, source_image, kp_driving, kp_source):
        out = self.first(source_image)
        for blk in self.down_blocks:
            out = blk(out)
        out = self.second(out)
        bs, _, h, w = out.shape
        feature_3d = self.resblocks_3d(
            out.reshape(bs, self.reshape_channel, self.reshape_depth, h, w))
        dense_motion = self.dense_motion_network(feature_3d, kp_driving,
                                                 kp_source)
        output = {"mask": dense_motion["mask"]}
        occlusion_map = dense_motion.get("occlusion_map")
        out = grid_sample_3d(feature_3d, dense_motion["deformation"])
        bs, c, d, h, w = out.shape
        out = self.fourth(self.third(out.reshape(bs, c * d, h, w)))
        if occlusion_map is not None:
            output["occlusion_map"] = occlusion_map
            if out.shape[2:] != occlusion_map.shape[2:]:
                occlusion_map = bilinear_resize(occlusion_map, out.shape[2:])
            out = out * occlusion_map
        output["prediction"] = self.decoder(out)
        return output
