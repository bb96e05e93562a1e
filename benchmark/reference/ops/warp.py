"""Grid sampling, affine warps and cv2's Gaussian blur.

``grid_sample_2d`` and ``grid_sample_3d`` are ``F.grid_sample`` (bilinear
or trilinear, zero padding; the grid's last axis is (x, y[, z]) in
[-1, 1]). ``affine_warp`` is
``cv2.warpAffine`` bilinear with a zero border, given the destination-to-
source matrix. ``gaussian_blur_cv2`` is ``cv2.GaussianBlur`` with cv2's taps
and BORDER_REFLECT_101, as two matmuls with the border folded into the
matrices (any kernel radius against any size, as ``jnp.pad`` reflects).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def grid_sample_2d(input, grid, align_corners: bool = False):
    """input [N,C,H,W]; grid [N,Ho,Wo,2] (x, y) -> [N,C,Ho,Wo]."""
    return F.grid_sample(input, grid.to(input.dtype), mode="bilinear",
                         padding_mode="zeros", align_corners=align_corners)


def grid_sample_3d(input, grid, align_corners: bool = False):
    """input [N,C,D,H,W]; grid [N,Do,Ho,Wo,3] (x, y, z) -> [N,C,Do,Ho,Wo]."""
    return F.grid_sample(input, grid.to(input.dtype), mode="bilinear",
                         padding_mode="zeros", align_corners=align_corners)


def _gather_2d(img, ix, iy):
    """img [C,H,W]; integer ix, iy [h,w] -> [C,h,w], zero outside."""
    C, H, W = img.shape
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    vals = img.reshape(C, H * W)[:, flat.reshape(-1)].reshape(C, *ix.shape)
    return torch.where(valid[None], vals, torch.zeros((), dtype=img.dtype,
                                                      device=img.device))


def affine_warp(img, m_inv, out_hw):
    """``cv2.warpAffine(img, M, dsize)`` bilinear with a zero border.
    img [C,H,W] float; ``m_inv`` [2,3]: the DESTINATION-to-source map (the
    inverse of cv2's M, which cv2 inverts itself), best already on img's
    device (a host array is copied there on every call)."""
    out_h, out_w = out_hw
    m = torch.as_tensor(m_inv, dtype=img.dtype, device=img.device)
    ys, xs = torch.meshgrid(
        torch.arange(out_h, dtype=img.dtype, device=img.device),
        torch.arange(out_w, dtype=img.dtype, device=img.device), indexing="ij")
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = sx - x0, sy - y0
    x0i, y0i = x0.long(), y0.long()
    top = (_gather_2d(img, x0i, y0i) * (1 - wx)
           + _gather_2d(img, x0i + 1, y0i) * wx)
    bot = (_gather_2d(img, x0i, y0i + 1) * (1 - wx)
           + _gather_2d(img, x0i + 1, y0i + 1) * wx)
    return top * (1 - wy) + bot * wy


def _reflect101(i: int, n: int) -> int:
    """cv2 BORDER_REFLECT_101 (numpy 'reflect'), folded as often as needed."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i %= period
    return i if i < n else period - i


@functools.lru_cache(maxsize=None)
def _gaussian_matrix(n: int, ksize: int, sigma: float, dtype: torch.dtype,
                     device: torch.device):
    """[n, n] matrix of the 1-D blur along one axis, border included, on the
    device once per shape."""
    r = ksize // 2
    i = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (i / np.float32(sigma)) ** 2)
    k = (k / k.sum()).astype(np.float32)
    G = np.zeros((n, n), np.float32)
    for o in range(n):
        for d in range(-r, r + 1):
            G[o, _reflect101(o + d, n)] += k[d + r]
    return torch.from_numpy(G).to(device, dtype)


def gaussian_blur_cv2(x, ksize: int, sigma: float):
    """``cv2.GaussianBlur(x, (ksize, ksize), sigma)`` on the last two axes:
    the kernel exp(-i^2 / (2 sigma^2)) normalised, BORDER_REFLECT_101."""
    if ksize % 2 != 1:
        raise ValueError(f"ksize must be odd, not {ksize}")
    H, W = x.shape[-2:]
    Gh = _gaussian_matrix(H, ksize, float(sigma), x.dtype, x.device)
    Gw = _gaussian_matrix(W, ksize, float(sigma), x.dtype, x.device)
    return Gh @ x @ Gw.T


@functools.lru_cache(maxsize=None)
def _sharpen_kernel(device: torch.device):
    k = torch.tensor([1.0, 2.0, 1.0])
    return (k[:, None] * k[None, :] / 16.0).to(device)


def filter2d_sharpen_u8(img_u8):
    """``cv2.filter2D(img, -1, k)`` on a uint8 [C,H,W] image with the 3x3
    kernel [1,2,1]x[1,2,1]/16 (GPEN's small-face step), BORDER_REFLECT_101,
    rounded and saturated to uint8."""
    k2 = _sharpen_kernel(img_u8.device).expand(img_u8.shape[0], 1, 3, 3)
    x = F.pad(img_u8.float()[None], (1, 1, 1, 1), mode="reflect")
    y = F.conv2d(x, k2, groups=img_u8.shape[0])[0]
    return torch.round(y).clamp(0, 255).to(torch.uint8)
