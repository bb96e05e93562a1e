"""Modulated convolution and E4S's region-masked (mask-guided) variant,
in plain PyTorch: the reference's 12-conv region loop,

    out = sum_r  M_r * d_r * conv(x * s_r, W)          (12 regions)

folded into the batch axis (no fused kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.ops.resize import nearest_resize
from benchmark.reference.ops.upfirdn2d import make_kernel, upfirdn2d

DEMOD_EPS = 1e-8


def demod_coeff(w_scaled, s):
    """rsqrt(sum_{i,k} (w*s)^2 + eps): w_scaled [Co,Ci,kh,kw], s [..., Ci]
    -> [..., Co], in float32."""
    w2 = (w_scaled.float() ** 2).sum(dim=(-2, -1))
    sig2 = torch.einsum("oi,...i->...o", w2, s.float() ** 2)
    return torch.rsqrt(sig2 + DEMOD_EPS)


def modulated_conv2d(x, w_scaled, s, *, demodulate=True, up=False,
                     blur_kernel=(1, 3, 3, 1)):
    """Shared-style modulated conv (layers >= K). x: [B,Ci,H,W];
    w_scaled: [Co,Ci,k,k]; s: [B,Ci]. conv(x, W*s) == conv(x*s, W), so the
    weight stays shared across the batch. ``up``: conv_transpose (stride 2)
    then the blur of the reference; ``blur_kernel`` is a tap list or the
    scaled 2-D kernel already on x's device (a module buffer)."""
    ksize = w_scaled.shape[-1]
    xm = x * s[:, :, None, None].to(x.dtype)
    if up:
        out = F.conv_transpose2d(xm, w_scaled.transpose(0, 1), stride=2)
        k = torch.as_tensor(blur_kernel)
        if k.ndim == 1:
            k = make_kernel(k) * 4.0
        p = (k.shape[0] - 2) - (ksize - 1)
        if demodulate:
            out = out * demod_coeff(w_scaled, s)[:, :, None, None].to(out.dtype)
        return upfirdn2d(out, k, pad=((p + 1) // 2 + 1, p // 2 + 1))
    out = F.conv2d(xm, w_scaled, padding=ksize // 2)
    if demodulate:
        out = out * demod_coeff(w_scaled, s)[:, :, None, None].to(out.dtype)
    return out


def masked_modulated_conv2d_naive(x, w_scaled, s, mask, *, demodulate=True,
                                  up=False, blur_kernel=(1, 3, 3, 1)):
    """The reference's 12-conv region loop, folded into the batch axis: the
    test oracle. x: [B,Ci,H,W]; s: [B,R,Ci]; mask: [B,R,Hm,Wm] one-hot."""
    B, R, Ci = s.shape
    H, W = x.shape[-2:]
    Ho, Wo = (2 * H, 2 * W) if up else (H, W)
    xt = x[:, None].expand(B, R, *x.shape[1:]).reshape(B * R, *x.shape[1:])
    out = modulated_conv2d(
        xt, w_scaled, s.reshape(B * R, Ci), demodulate=demodulate, up=up,
        blur_kernel=blur_kernel,
    )
    out = out.reshape(B, R, -1, Ho, Wo)
    seg = nearest_resize(mask, (Ho, Wo)).to(out.dtype)
    return torch.einsum("brohw,brhw->bohw", out, seg)


def _region_maps(seg, s, d, dtype):
    """Per-pixel style / demod maps from one-hot ``seg`` [B,R,H,W] already at
    the output resolution: smap [B,H,W,Ci], dmap [B,H,W,Co] or None, both
    contiguous NHWC (the kernel's layout)."""
    seg = seg.to(dtype)
    smap = torch.einsum("brhw,bri->bhwi", seg, s.to(dtype)).contiguous()
    dmap = None
    if d is not None:
        dmap = torch.einsum("brhw,bro->bhwo", seg, d.to(dtype)).contiguous()
    return smap, dmap


def masked_torgb(x, w_scaled, s, mask):
    """Mask-guided ToRGB: 1x1 modulated conv without demodulation.
    x: [B,Ci,H,W]; w_scaled: [3,Ci,1,1]; s: [B,R,Ci]; mask: [B,R,Hm,Wm]."""
    H, W = x.shape[-2:]
    smap, _ = _region_maps(nearest_resize(mask, (H, W)), s, None, x.dtype)
    out = torch.matmul(
        smap * x.permute(0, 2, 3, 1), w_scaled[:, :, 0, 0].t().to(x.dtype)
    )
    return out.permute(0, 3, 1, 2)
