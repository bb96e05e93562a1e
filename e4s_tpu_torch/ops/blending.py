"""Laplacian-pyramid (multi-band) blending with OpenCV's pyramid
(counterpart of ``e4s_tpu/ops/blending.py``): the 5-tap Gaussian
[1,4,6,4,1]/16 with REFLECT_101 borders, as ``cv2.pyrDown``/``cv2.pyrUp``.

The pyramid of a 1024^2 image goes down to 2x2 and 1x1, where a pad of 2 is
not smaller than the side. ``F.pad(mode="reflect")`` refuses that; numpy's
(and JAX's) reflect keeps reflecting: [0,1] -> [0,1,0,1,0,1], [0] ->
[0,0,0,0,0]. The padding here is a gather by an index that numpy builds,
so it matches at every size on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from e4s_tpu_torch.ops.resize import bilinear_resize

_GAUSS_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


@functools.lru_cache(maxsize=None)
def _reflect_index(n: int, device: torch.device):
    """Indices of numpy's ``pad(arange(n), 2, mode="reflect")`` on
    ``device``; built once per (size, device)."""
    return torch.as_tensor(np.pad(np.arange(n), 2, mode="reflect"), device=device)


@functools.lru_cache(maxsize=None)
def _taps(gain: float, dtype: torch.dtype, device: torch.device):
    """The 5 taps times ``gain``, as a [5] tensor on ``device``."""
    return torch.as_tensor(_GAUSS_1D * gain, dtype=dtype, device=device)


def _blur5(x, gain: float = 1.0, stride: int = 1):
    """Separable 5-tap Gaussian with REFLECT_101 borders, kept at every
    ``stride``-th row and column. x: [B,C,H,W]. The depthwise convs take
    contiguous inputs; on the CPU they take channels-last ones instead (same
    values, ~2x faster there), which is what keeps the CPU parity tests of
    the 1024^2 blend short. On the GPU that layout change would cost two
    copies per blur (+0.46 ms per blend on an H100)."""
    C, H, W = x.shape[1:]
    k = _taps(gain, x.dtype, x.device)
    cl = torch.channels_last if x.device.type == "cpu" else torch.contiguous_format
    xp = x.index_select(2, _reflect_index(H, x.device)).contiguous(memory_format=cl)
    x = F.conv2d(xp, k.reshape(1, 1, 5, 1).expand(C, 1, 5, 1),
                 stride=(stride, 1), groups=C)
    xp = x.index_select(3, _reflect_index(W, x.device)).contiguous(memory_format=cl)
    return F.conv2d(xp, k.reshape(1, 1, 1, 5).expand(C, 1, 1, 5),
                    stride=(1, stride), groups=C)


def pyr_down(x):
    """cv2.pyrDown: Gaussian blur at the even rows and columns."""
    return _blur5(x, stride=2)


def pyr_up(x):
    """cv2.pyrUp: zero-stuff 2x, then the Gaussian with gain 2 per axis."""
    B, C, H, W = x.shape
    up = x.new_zeros((B, C, 2 * H, 2 * W))
    up[:, :, ::2, ::2] = x
    return _blur5(up, gain=2.0)


def laplacian_blend(a, b, mask, num_levels: int = 10):
    """Blend ``a`` over ``b`` under ``mask`` band by band:
    out = sum over bands of lap_a * m + lap_b * (1 - m).
    a, b: [B,C,H,W]; mask: [B,C,H,W] in [0,1] (channels broadcast). The
    three pyramids are built as one batch, and each level's three upsamples
    are one call."""
    n = a.shape[0]
    g = [torch.cat([a, b, mask.expand_as(a)])]
    for _ in range(num_levels):
        g.append(pyr_down(g[-1]))
    ga, gb, gm = g[num_levels - 1].split(n)
    ls = ga * gm + gb * (1.0 - gm)
    for i in range(num_levels - 1, 0, -1):
        ua, ub, uls = pyr_up(torch.cat([g[i][:2 * n], ls])).split(n)
        pa, pb, m = g[i - 1].split(n)
        ls = uls + (pa - ua) * m + (pb - ub) * (1.0 - m)
    return ls


def blend_images(full_img, ori_img, mask, num_levels: int = 10):
    """The multi-band blend in [0,255], always at 1024^2 and resized back
    to ``ori_img``'s size. full_img, ori_img: [B,3,H,W] in [0,255]; mask:
    [B,C,H,W] in [0,1]."""
    H, W = ori_img.shape[-2:]
    fi = bilinear_resize(full_img, (1024, 1024))
    oi = bilinear_resize(ori_img, (1024, 1024))
    m = bilinear_resize(mask, (1024, 1024))
    out = torch.clamp(laplacian_blend(fi, oi, m, num_levels), 0.0, 255.0)
    return bilinear_resize(out, (H, W))
