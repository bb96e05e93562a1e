"""Resizes with PyTorch's ``F.interpolate`` conventions, skimage's
anti-aliased resize, and cv2's uint8 ``INTER_LINEAR``
resize of GPEN's host glue.
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _cv2_linear_taps(n_in: int, n_out: int, device: torch.device):
    """cv2's ``INTER_LINEAR`` taps along one axis: the two source indices
    (replicated at the borders, where cv2 keeps the fraction) and their
    weights in 11-bit fixed point, computed in float32 as cv2 does."""
    scale = 1.0 / (n_out / n_in)
    f = np.float32((np.arange(n_out) + 0.5) * scale - 0.5)
    i0 = np.floor(f)
    f = (f - i0).astype(np.float32)
    w = np.stack([np.rint((np.float32(1) - f) * 2048), np.rint(f * 2048)])
    idx = np.stack([np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1)])
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(w.astype(np.int32)).to(device))


def resize_u8(x, size):
    """``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) of a uint8 tensor's
    last two axes, bit for bit: an exact 2x reduction is cv2's
    ``INTER_AREA`` there (the 2x2 sum, + 2, >> 2); every other ratio is
    cv2's fixed-point bilinear (no antialiasing): the horizontal pass with
    11-bit weights in int32, then the vertical one as its vector path does
    it, ((D0 >> 4) * b0 >> 16) + ((D1 >> 4) * b1 >> 16), + 2, >> 2."""
    H, W = x.shape[-2:]
    h, w = size
    if (H, W) == (h, w):
        return x
    xi = x.to(torch.int32)
    if (H, W) == (2 * h, 2 * w):
        s = xi[..., 0::2, 0::2] + xi[..., 0::2, 1::2] + xi[..., 1::2, 0::2] + xi[..., 1::2, 1::2]
        return ((s + 2) >> 2).to(torch.uint8)
    (ix, ax), (iy, by) = (_cv2_linear_taps(W, w, x.device), _cv2_linear_taps(H, h, x.device))
    d = xi.index_select(-1, ix[0]) * ax[0] + xi.index_select(-1, ix[1]) * ax[1]
    d0, d1 = (d.index_select(-2, iy[k]) >> 4 for k in (0, 1))
    t = ((d0 * by[0, :, None]) >> 16) + ((d1 * by[1, :, None]) >> 16)
    return ((t + 2) >> 2).clamp(0, 255).to(torch.uint8)


def adaptive_avg_pool2d(x, size):
    """``F.adaptive_avg_pool2d``."""
    return F.adaptive_avg_pool2d(x, size)


@functools.lru_cache(maxsize=None)
def _skimage_resize_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                           device: torch.device):
    """[out, in] matrix of ``skimage.transform.resize`` (order=1,
    mode='reflect', anti_aliasing) along one axis: a Gaussian pre-filter
    with sigma = (in/out - 1) / 2, truncated at 4 sigma, 'mirror' border,
    then bilinear sampling at src = (o + 0.5) * in/out - 0.5."""
    factor = in_size / out_size
    Z = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        src = min(max((o + 0.5) * factor - 0.5, 0.0), in_size - 1)
        i0 = int(np.floor(src))
        i1 = min(i0 + 1, in_size - 1)
        w = src - i0
        Z[o, i0] += 1.0 - w
        Z[o, i1] += w
    sigma = max(0.0, (factor - 1) / 2)
    if sigma == 0:
        return torch.from_numpy(Z).to(device, dtype)
    radius = int(4.0 * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    k /= k.sum()
    G = np.zeros((in_size, in_size), np.float64)
    for i in range(in_size):
        for dj, kv in zip(range(-radius, radius + 1), k):
            j = i + dj
            if j < 0:  # 'mirror' == reflect_101: -1 -> 1
                j = -j
            elif j >= in_size:
                j = 2 * (in_size - 1) - j
            G[i, j] += kv
    return torch.from_numpy((Z @ G).astype(np.float32)).to(device, dtype)


def antialiased_resize(x, size):
    """``skimage.transform.resize`` (order 1, Gaussian anti-aliasing) of the
    last two axes as two matmuls; integer inputs are resized as float32."""
    H, W = x.shape[-2], x.shape[-1]
    out_h, out_w = size
    if (H, W) == (out_h, out_w):
        return x
    if not x.is_floating_point():
        x = x.float()
    Ah = _skimage_resize_matrix(H, out_h, x.dtype, x.device)
    Aw = _skimage_resize_matrix(W, out_w, x.dtype, x.device)
    return Ah @ x @ Aw.T
