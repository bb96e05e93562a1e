"""Dense motion network: sparse 3-D keypoint motions -> a dense deformation
and an occlusion map."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.encoders import FrozenBatchNorm
from benchmark.reference.models.facevid2vid.util import (
    Hourglass3D,
    kp2gaussian,
    make_coordinate_grid_3d,
)
from benchmark.reference.ops.warp import grid_sample_3d


class DenseMotionNetwork(nn.Module):
    """vox-256: block 32, 5 blocks, max 1024, compress 4, depth 16,
    occlusion on."""

    def __init__(self, block_expansion=32, num_blocks=5, max_features=1024,
                 num_kp=15, feature_channel=32, reshape_depth=16, compress=4,
                 estimate_occlusion_map=True):
        super().__init__()
        self.hourglass = Hourglass3D(
            block_expansion, in_features=(num_kp + 1) * (compress + 1),
            num_blocks=num_blocks, max_features=max_features)
        self.mask = nn.Conv3d(self.hourglass.out_filters, num_kp + 1, 7,
                              padding=3)
        self.compress = nn.Conv3d(feature_channel, compress, 1)
        self.norm = FrozenBatchNorm(compress)
        if estimate_occlusion_map:
            self.occlusion = nn.Conv2d(self.hourglass.out_filters * reshape_depth,
                                       1, 7, padding=3)
        else:
            self.occlusion = None
        self.num_kp = num_kp

    def create_sparse_motions(self, feature, kp_driving, kp_source):
        bs, _, d, h, w = feature.shape
        identity = make_coordinate_grid_3d(d, h, w, feature.dtype,
                                           feature.device)[None, None]
        k = self.num_kp
        coordinate_grid = identity - kp_driving["value"].reshape(bs, k, 1, 1, 1, 3)
        driving_to_source = coordinate_grid + kp_source["value"].reshape(
            bs, k, 1, 1, 1, 3)
        return torch.cat([identity.expand(bs, 1, d, h, w, 3), driving_to_source],
                         dim=1)

    def create_deformed_feature(self, feature, sparse_motions):
        bs, c, d, h, w = feature.shape
        k1 = self.num_kp + 1
        feat = feature[:, None].expand(bs, k1, c, d, h, w).reshape(bs * k1, c, d, h, w)
        deformed = grid_sample_3d(feat, sparse_motions.reshape(bs * k1, d, h, w, 3))
        return deformed.reshape(bs, k1, c, d, h, w)

    def create_heatmap_representations(self, feature, kp_driving, kp_source):
        spatial = feature.shape[3:]
        heatmap = (kp2gaussian(kp_driving["value"], spatial, 0.01)
                   - kp2gaussian(kp_source["value"], spatial, 0.01))
        zeros = heatmap.new_zeros((heatmap.shape[0], 1) + tuple(spatial))
        return torch.cat([zeros, heatmap], dim=1)[:, :, None]

    def forward(self, feature, kp_driving, kp_source):
        bs, _, d, h, w = feature.shape
        feature = F.relu(self.norm(self.compress(feature)))
        sparse_motion = self.create_sparse_motions(feature, kp_driving, kp_source)
        deformed = self.create_deformed_feature(feature, sparse_motion)
        heatmap = self.create_heatmap_representations(deformed, kp_driving,
                                                      kp_source)
        inp = torch.cat([heatmap, deformed], dim=2).reshape(bs, -1, d, h, w)
        prediction = self.hourglass(inp)
        mask = F.softmax(self.mask(prediction), dim=1)
        out = {"mask": mask,
               "deformation": (sparse_motion * mask[..., None]).sum(dim=1)}
        if self.occlusion is not None:
            out["occlusion_map"] = torch.sigmoid(
                self.occlusion(prediction.reshape(bs, -1, h, w)))
        return out
