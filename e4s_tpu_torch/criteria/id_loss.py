"""ArcFace identity loss (counterpart of ``e4s_tpu/criteria/id_loss.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from e4s_tpu_torch.models.encoders import IRSE50Backbone
from e4s_tpu_torch.ops.resize import adaptive_avg_pool2d


def feature_similarity_loss(y_hat_feats, y_feats):
    """(sum over scales of mean(1 - <f(y_hat), f(y)>), the summed mean gain
    of that similarity over <f(y), f(y)>); y's features carry no gradient."""
    loss = 0.0
    sim_improvement = 0.0
    for fh, f in zip(y_hat_feats, y_feats):
        sim_target = (fh * f).sum(dim=1)
        sim_views = (f * f).sum(dim=1)
        loss = loss + (1.0 - sim_target).mean()
        sim_improvement = sim_improvement + (sim_target - sim_views).mean()
    return loss, sim_improvement


class IDLoss(nn.Module):
    """forward(y_hat, y) [B,3,H,W] in [-1,1] -> (loss, sim_improvement) over
    the IR-SE50 features (``multiscale``: four trunk taps and the
    embedding). ``facenet`` takes ``model_ir_se50.pth``."""

    def __init__(self, multiscale: bool = True):
        super().__init__()
        self.multiscale = multiscale
        self.facenet = IRSE50Backbone()

    def extract_feats(self, x):
        """Pool to 256^2, crop rows 35:223 and columns 32:220, pool to 112^2."""
        if x.shape[2] != 256:
            x = adaptive_avg_pool2d(x, (256, 256))
        x = adaptive_avg_pool2d(x[:, :, 35:223, 32:220], (112, 112))
        return self.facenet(x, multi_scale=self.multiscale)

    def forward(self, y_hat, y):
        with torch.no_grad():
            y_feats = self.extract_feats(y)
        return feature_similarity_loss(self.extract_feats(y_hat), y_feats)
