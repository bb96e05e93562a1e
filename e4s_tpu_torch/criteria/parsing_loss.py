"""Face-parsing feature loss (counterpart of
``e4s_tpu/criteria/parsing_loss.py``): cosine similarity of the five
l2-normalised U-Net encoder features at 512^2."""

from __future__ import annotations

import torch
import torch.nn as nn

from e4s_tpu_torch.criteria.id_loss import feature_similarity_loss
from e4s_tpu_torch.models.unet import ParsingUNet
from e4s_tpu_torch.ops.resize import adaptive_avg_pool2d


class FaceParsingLoss(nn.Module):
    """forward(y_hat, y) [B,3,H,W] -> (loss, sim_improvement). ``G`` takes
    the parsing U-Net's ``model.pth``."""

    def __init__(self):
        super().__init__()
        self.G = ParsingUNet()

    def extract_feats(self, x):
        if x.shape[2] != 512:
            x = adaptive_avg_pool2d(x, (512, 512))
        return self.G(x, extract_feats_only=True)

    def forward(self, y_hat, y):
        with torch.no_grad():
            y_feats = self.extract_feats(y)
        return feature_similarity_loss(self.extract_feats(y_hat), y_feats)
