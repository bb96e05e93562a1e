"""Per-region mean of feature vectors under one-hot masks: the reference's per-(sample, region)
``masked_select`` loop as two einsums.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.resize import nearest_resize


def masked_region_mean(feats, segmap):
    """feats: [B,F,H,W]; segmap: [B,R,H',W'] one-hot, nearest-resized to
    (H,W). Returns [B,R,F]; empty regions come out exactly 0."""
    H, W = feats.shape[-2:]
    seg = nearest_resize(segmap, (H, W)).to(feats.dtype)
    sums = torch.einsum("bfhw,brhw->brf", feats, seg)
    counts = seg.sum(dim=(-2, -1))[..., None]
    mean = sums / counts.clamp(min=1.0)
    return torch.where(counts > 0, mean, torch.zeros_like(mean))
