"""Modulated convolution and E4S's region-masked (mask-guided) variant.

Counterpart of ``e4s_tpu/ops/modconv.py``. For the first K layers E4S runs
the StyleGAN2 modulated conv once per facial region r with that region's
style and sums the outputs under the one-hot region masks:

    out = sum_r  M_r * d_r * conv(x * s_r, W)          (12 regions)

The masks are a disjoint partition, so the sum collapses pointwise to one
conv whose modulation is gathered at the OUTPUT pixel:

    out[o,p] = dmap[o,p] * sum_{i,t} W[o,i,t] * smap[i,p] * x[i,p+t]
    smap[i,p] = sum_r M_r[p] s_r[i]        dmap[o,p] = sum_r M_r[p] d_r[o]

which is exactly what ``patch_mod_conv3_nhwc`` (the CUDA kernel) computes.
An upsampling layer is conv_transpose(stride 2) followed by a FIR blur; that
composite splits into 4 polyphase 3x3 kernels, each run as the same
patch-modulated conv at the input resolution and interleaved to 2x.

Tensors are NCHW-shaped. The synthesis keeps them in ``torch.channels_last``
memory, so the kernel's NHWC view is a free permute and its NHWC output goes
back as a channels-last NCHW view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from e4s_tpu_torch.ops.patch_modconv import patch_mod_conv3_nhwc
from e4s_tpu_torch.ops.resize import nearest_resize
from e4s_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d

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


def _composite_up_kernel(w_scaled, bk):
    """E[o,i,c] = sum_s bk[s] * w[o,i,c-s] (full 2-D convolution of the 3x3
    weight with the 4x4 blur): the 6x6 kernel of blur o conv_transpose2,
    computed as 16 exact shifted adds."""
    Co, Ci, kh, kw = w_scaled.shape
    bh, bw = bk.shape
    E = w_scaled.new_zeros((Co, Ci, kh + bh - 1, kw + bw - 1))
    for sy in range(bh):
        for sx in range(bw):
            E[:, :, sy:sy + kh, sx:sx + kw] += float(bk[sy, sx]) * w_scaled
    return E


def masked_modulated_conv2d(x, w_scaled, s, mask, *, demodulate=True,
                            up=False, blur_kernel=(1, 3, 3, 1)):
    """Exact fast path of the mask-guided modulated conv (module docstring).

    x: [B,Ci,H,W]; w_scaled: [Co,Ci,3,3]; s: [B,R,Ci]; mask: [B,R,Hm,Wm].
    Returns [B,Co,H,W] (or 2x for ``up``) in channels-last memory. Every
    3x3 conv here is one launch of the CUDA kernel on a GPU tensor (4 for an
    upsampling layer)."""
    B, R, Ci = s.shape
    H, W = x.shape[-2:]
    d = demod_coeff(w_scaled, s) if demodulate else None
    xh = x.permute(0, 2, 3, 1).contiguous()  # free for channels-last x

    if not up:
        smap, dmap = _region_maps(nearest_resize(mask, (H, W)), s, d, x.dtype)
        return patch_mod_conv3_nhwc(xh, w_scaled, smap, dmap).permute(0, 3, 1, 2)

    if w_scaled.shape[-1] != 3 or len(blur_kernel) != 4:
        raise ValueError("the polyphase path takes k=3 and a 4-tap blur only")
    E = _composite_up_kernel(w_scaled, make_kernel(blur_kernel) * 4.0)
    seg_full = nearest_resize(mask, (2 * H, 2 * W))
    phases = []
    for a in (0, 1):
        row = []
        for b in (0, 1):
            # phase kernel K_ab[t] = E[a+4-2t], t in {0,1,2}
            Kab = E[:, :, a::2, b::2].flip((2, 3))
            sm, dm = _region_maps(seg_full[:, :, a::2, b::2], s, d, x.dtype)
            row.append(patch_mod_conv3_nhwc(xh, Kab, sm, dm))
        phases.append(torch.stack(row, dim=3))  # [B,H,W,b,Co]
    out = torch.stack(phases, dim=2)  # [B,H,a,W,b,Co]
    Co = w_scaled.shape[0]
    return out.reshape(B, 2 * H, 2 * W, Co).permute(0, 3, 1, 2)


def masked_torgb(x, w_scaled, s, mask):
    """Mask-guided ToRGB: 1x1 modulated conv without demodulation.
    x: [B,Ci,H,W]; w_scaled: [3,Ci,1,1]; s: [B,R,Ci]; mask: [B,R,Hm,Wm]."""
    H, W = x.shape[-2:]
    smap, _ = _region_maps(nearest_resize(mask, (H, W)), s, None, x.dtype)
    out = torch.matmul(
        smap * x.permute(0, 2, 3, 1), w_scaled[:, :, 0, 0].t().to(x.dtype)
    )
    return out.permute(0, 3, 1, 2)
