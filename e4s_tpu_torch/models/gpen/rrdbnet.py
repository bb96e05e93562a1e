"""RRDBNet, the RealESRNet super-resolution trunk (counterpart of
``e4s_tpu/models/gpen/rrdbnet.py``; 32 features, 23 blocks).

On a CUDA float32 input with no gradient wanted, ``RRDBNet.forward`` runs
its 349 convs with 32 outputs (the trunk's 345, ``conv_body``, the up path)
on ``ops/conv3x3_n32.py``'s kernel in NHWC, as one table of steps
(``forward_nhwc``); ``conv_first`` and ``conv_last`` stay ``nn.Conv2d``.
Elsewhere (the CPU, bf16, autograd) it runs the modules as written.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from e4s_tpu_torch.ops import conv3x3_n32 as n32
from e4s_tpu_torch.ops.kernel_lib import cached


def pixel_unshuffle(x, scale: int):
    """Space-to-depth: [B,C,H,W] -> [B,C*scale^2,H/scale,W/scale]."""
    return F.pixel_unshuffle(x, scale)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat=32, num_grow_ch=32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", nn.Conv2d(
                num_feat + i * num_grow_ch, num_grow_ch, 3, 1, 1))
        self.conv5 = nn.Conv2d(num_feat + 4 * num_grow_ch, num_feat, 3, 1, 1)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            feats.append(_lrelu(getattr(self, f"conv{i + 1}")(torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat=32, num_grow_ch=32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """forward(x [B,3,H,W] in [0,1]) -> [B,3,H*scale/..,..]: x4 for scale 4
    (scale 2 and 1 first pixel-unshuffle by 2 and 4)."""

    def __init__(self, num_in_ch=3, num_out_ch=3, scale=4, num_feat=32,
                 num_block=23, num_grow_ch=32):
        super().__init__()
        self.scale = scale
        self.num_feat, self.num_grow_ch = num_feat, num_grow_ch
        self._kernel = None  # (convs, steps) of the kernel path
        in_ch = num_in_ch * {2: 4, 1: 16}.get(scale, 1)
        self.conv_first = nn.Conv2d(in_ch, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, 1, 1)

    def forward(self, x):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        if self.num_feat == self.num_grow_ch == n32.CO and n32.kernel_takes(
                x.device, x.dtype, torch.is_grad_enabled(), self.num_feat):
            return self.forward_nhwc(x)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        for conv in (self.conv_up1, self.conv_up2):
            feat = _lrelu(conv(feat.repeat_interleave(2, -2).repeat_interleave(2, -1)))
        return self.conv_last(_lrelu(self.conv_hr(feat)))

    def _convs(self):
        """The convs of ``_steps``, in its order."""
        return [getattr(rdb, f"conv{i}") for rrdb in self.body
                for rdb in (rrdb.rdb1, rrdb.rdb2, rrdb.rdb3) for i in range(1, 6)] + [
            self.conv_body, self.conv_up1, self.conv_up2, self.conv_hr]

    def _steps(self):
        """The forward between ``conv_first`` and ``conv_last`` as a table of
        ``n32.Step`` on 7 NHWC buffers: 0 the features [B,H,W,32]; 1-3 three
        dense blocks [B,H,W,160]; 4-6 the up path [B,2H,2W,32], [B,4H,4W,32]
        twice. An RRDB's input sits in channels 0-31 of buffer 1; its first
        dense block works in buffer 1 and writes its result into buffer 2's
        channels 0-31, the second from 2 into 3, and the third's conv5 writes
        the RRDB's result over its input."""
        C, G = self.num_feat, self.num_grow_ch
        steps = []
        for _ in self.body:
            for x, nxt in ((1, 2), (2, 3), (3, 1)):
                steps += [n32.Step(x, C + i * G, x, C + i * G, lrelu=True)
                          for i in range(4)]
                steps.append(n32.Step(x, C + 4 * G, nxt, r1=x, a1=0.2,
                                      r2=1 if nxt == 1 else None, a2=0.2))
        return steps + [
            n32.Step(1, C, 0, r1=0),  # feat + conv_body(body(feat))
            n32.Step(0, C, 4, up=True, lrelu=True),
            n32.Step(4, C, 5, up=True, lrelu=True),
            n32.Step(5, C, 6, lrelu=True)]

    def _table(self, device):
        """(convs, steps, packed) of the kernel path: the convs and their
        ``_steps`` made once; on a CUDA device their ``n32.pack``, kept by
        ``kernel_lib.cached`` over all 698 weights and biases."""
        if self._kernel is None:
            self._kernel = (self._convs(), self._steps())
        convs, steps = self._kernel
        if device.type != "cuda":
            return convs, steps, None
        ws, bs = [c.weight for c in convs], [c.bias for c in convs]
        return convs, steps, cached(self, ws + bs, lambda: n32.pack(steps, ws, bs))

    def forward_nhwc(self, x):
        """The forward after the pixel unshuffle with the 32-channel convs as
        ``_steps`` (the kernel on a CUDA tensor, its plain version on the CPU):
        ``conv_first``, one copy to NHWC, the table, ``conv_last`` on the NHWC
        buffer (cuDNN reads it in place), its NCHW result."""
        feat = self.conv_first(x)
        B, C, H, W = feat.shape
        f = feat.permute(0, 2, 3, 1).contiguous()
        dense = [f.new_empty((B, H, W, C + 4 * self.num_grow_ch)) for _ in range(3)]
        dense[0][..., :C] = f
        bufs = [f, *dense, *(f.new_empty((B, s * H, s * W, C)) for s in (2, 4, 4))]
        convs, steps, packed = self._table(f.device)
        n32.run(steps, bufs, [c.weight for c in convs], [c.bias for c in convs], packed)
        return self.conv_last(bufs[6].permute(0, 3, 1, 2)).contiguous()
