"""Resizes with PyTorch's ``F.interpolate`` conventions (counterpart of
``e4s_tpu/ops/resize.py``, which reproduces these same conventions in JAX).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    # torch nearest (asymmetric, floor): idx = floor(i * in / out)
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def nearest_resize(x, size):
    """Nearest resize of the last two axes, ``src = floor(dst * in / out)``.
    Works on any dtype (label maps included)."""
    H, W = x.shape[-2], x.shape[-1]
    out_h, out_w = size
    if (H, W) == (out_h, out_w):
        return x
    if H % out_h == 0 and W % out_w == 0:
        return x[..., :: H // out_h, :: W // out_w]
    iy = torch.as_tensor(_nearest_indices(H, out_h), device=x.device)
    ix = torch.as_tensor(_nearest_indices(W, out_w), device=x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def bilinear_resize(x, size, align_corners: bool = False):
    """``F.interpolate(mode='bilinear')`` without antialiasing, on the last
    two axes of a 3-D or 4-D tensor; integer inputs are resized as float32."""
    H, W = x.shape[-2], x.shape[-1]
    if (H, W) == tuple(size):
        return x
    if not x.is_floating_point():
        x = x.float()
    lead = x.shape[:-2]
    y = F.interpolate(
        x.reshape(-1, 1, H, W) if x.ndim != 4 else x, size=tuple(size),
        mode="bilinear", align_corners=align_corners,
    )
    return y.reshape(*lead, *size)


def adaptive_avg_pool2d(x, size):
    """``F.adaptive_avg_pool2d`` (the JAX package re-derives its index rule)."""
    return F.adaptive_avg_pool2d(x, size)
