"""Flat grayscale dilation / erosion and the stitch masks. Geodesic borders: the
padding value never wins the reduction.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAX_VAL = 1e4


def _flat_max(x, kernel, pad_val):
    kernel = np.asarray(kernel)
    if not np.all(kernel != 0):
        raise ValueError("only flat (all-ones) structuring elements are supported")
    kh, kw = kernel.shape
    oy, ox = kh // 2, kw // 2
    xp = F.pad(x, (ox, kw - ox - 1, oy, kh - oy - 1), value=pad_val)
    return F.max_pool2d(xp, (kh, kw), stride=1)


def dilation(x, kernel):
    """Max over the structuring element. x: [B,C,H,W]."""
    return _flat_max(x, kernel, -MAX_VAL)


def erosion(x, kernel):
    """Min over the structuring element. x: [B,C,H,W]."""
    return -_flat_max(-x, kernel, -MAX_VAL)


def create_masks(mask, outer_dilation: int = 0, operation: str = "dilation"):
    """(content, border, full) masks for stitching; mask: [B,1,H,W] in {0,1}."""
    k = np.ones((2 * outer_dilation + 1, 2 * outer_dilation + 1), np.float32)
    if operation == "dilation":
        full_mask = dilation(mask, k)
        border_mask = full_mask - mask
    elif operation == "erosion":
        full_mask = erosion(mask, k)
        border_mask = mask - full_mask
    elif operation == "expansion":
        full_mask = dilation(mask, k)
        border_mask = full_mask - erosion(mask, k)
    else:
        raise ValueError(operation)
    return mask, torch.clamp(border_mask, 0, 1), full_mask
