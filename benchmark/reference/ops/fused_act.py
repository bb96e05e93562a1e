"""Bias + LeakyReLU + gain.

The reference's CUDA op is an elementwise pass; here it is plain PyTorch.
"""

from __future__ import annotations

import math

import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = SQRT2):
    """scale * leaky_relu(x + bias); ``bias`` [C] broadcasts over axis 1 for
    rank >= 3 inputs (NCHW maps) and over the last axis otherwise."""
    if bias is not None:
        if x.ndim >= 3:
            x = x + bias.reshape([1, -1] + [1] * (x.ndim - 2)).to(x.dtype)
        else:
            x = x + bias.to(x.dtype)
    return F.leaky_relu(x, negative_slope) * scale


def scaled_leaky_relu(x, negative_slope: float = 0.2):
    """LeakyReLU followed by the sqrt(2) gain (no bias)."""
    return F.leaky_relu(x, negative_slope) * SQRT2
