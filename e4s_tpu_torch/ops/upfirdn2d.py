"""upfirdn2d: upsample (zero-stuff) -> FIR filter -> downsample, with padding.

Counterpart of ``e4s_tpu/ops/upfirdn2d.py``; the semantics are the
reference's ``upfirdn2d_native``. Tensors are NCHW-shaped in any memory
format; the filter is a depthwise ``F.conv2d`` with the flipped kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_kernel(k) -> torch.Tensor:
    """Normalised 2-D FIR kernel from a 1-D or 2-D tap list."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """x: [B,C,H,W]; kernel: [kh,kw] (correlated flipped, i.e. convolved).

    Output extent: (H*up + pad0 + pad1 - kh) // down + 1 per axis; pads may
    be negative (they crop)."""
    B, C, H, W = x.shape
    kh, kw = kernel.shape
    pad0, pad1 = pad
    if up > 1:
        x = x.reshape(B, C, H, 1, W, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(B, C, H * up, W * up)
    x = F.pad(x, (max(pad0, 0), max(pad1, 0), max(pad0, 0), max(pad1, 0)))
    x = x[
        :, :,
        max(-pad0, 0): x.shape[2] - max(-pad1, 0),
        max(-pad0, 0): x.shape[3] - max(-pad1, 0),
    ]
    w = torch.flip(kernel, (0, 1)).to(x.dtype).to(x.device)
    w = w.reshape(1, 1, kh, kw).expand(C, 1, kh, kw)
    return F.conv2d(x, w, stride=down, groups=C)


def blur(x, kernel, pad, upsample_factor: int = 1):
    """StyleGAN2 Blur block: FIR filter, with gain after an upsample."""
    k = make_kernel(kernel)
    if upsample_factor > 1:
        k = k * (upsample_factor ** 2)
    return upfirdn2d(x, k, pad=pad)


def upsample2(x, kernel=(1, 3, 3, 1), factor: int = 2):
    """2x FIR upsample. ``kernel`` is a tap list, or the already scaled 2-D
    kernel (``make_kernel(taps) * factor**2``, a module's buffer)."""
    k = torch.as_tensor(kernel)
    if k.ndim == 1:
        k = make_kernel(k) * (factor ** 2)
    p = k.shape[0] - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return upfirdn2d(x, k, up=factor, down=1, pad=(pad0, pad1))

