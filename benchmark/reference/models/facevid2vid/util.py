"""FaceVid2Vid building blocks: 2-D and 3-D conv blocks,
hourglasses, SPADE. Module names are the reference's, so its
``00000189-checkpoint.pth.tar`` loads with ``load_state_dict``. Every norm
is frozen (the net runs in eval mode); spectral norm is applied as PyTorch's
eval-mode ``spectral_norm`` does, W = W_orig / (u^T W_orig v).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models.encoders import FrozenBatchNorm, InstanceNorm
from benchmark.reference.ops.resize import nearest_resize


def make_coordinate_grid_3d(d, h, w, dtype=torch.float32, device=None):
    """[d,h,w,3] grid over [-1,1]^3, last axis (x, y, z)."""
    def axis(n):
        return 2 * (torch.arange(n, dtype=dtype, device=device) / (n - 1)) - 1

    zz, yy, xx = torch.meshgrid(axis(d), axis(h), axis(w), indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def kp2gaussian(kp_value, spatial_size, kp_variance):
    """kp_value [B,K,3] -> Gaussians [B,K,d,h,w]."""
    d, h, w = spatial_size
    grid = make_coordinate_grid_3d(d, h, w, kp_value.dtype, kp_value.device)
    diff = grid[None, None] - kp_value[:, :, None, None, None, :]
    return torch.exp(-0.5 * (diff ** 2).sum(-1) / kp_variance)


class SNConv2d(nn.Module):
    """A Conv2d under eval-mode spectral norm, with the keys of
    ``torch.nn.utils.spectral_norm``: ``weight_orig``, ``weight_u``,
    ``weight_v`` (and ``bias``). Seeded random weights take u and v from a
    power iteration, as training would have left them."""

    def __init__(self, in_channels, out_channels, kernel_size, padding=0,
                 bias=True):
        super().__init__()
        self.padding = padding
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.register_buffer("weight_u", torch.empty(out_channels))
        self.register_buffer("weight_v",
                             torch.empty(in_channels * kernel_size ** 2))

    def reset_parameters(self, generator):
        with torch.no_grad():
            bound = 1.0 / math.sqrt(self.weight_orig[0].numel())
            self.weight_orig.copy_(generator.uniform(self.weight_orig.shape, bound))
            if self.bias is not None:
                self.bias.copy_(generator.uniform(self.bias.shape, bound))
            w = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
            u = F.normalize(generator.normal((w.shape[0],)), dim=0)
            for _ in range(8):
                v = F.normalize(w.T @ u, dim=0)
                u = F.normalize(w @ v, dim=0)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)

    def weight(self):
        w = self.weight_orig
        sigma = torch.dot(self.weight_u, w.reshape(w.shape[0], -1) @ self.weight_v)
        return w / sigma

    def forward(self, x):
        return F.conv2d(x, self.weight(), self.bias, padding=self.padding)


class ResBottleneck(nn.Module):
    def __init__(self, in_features, stride=1):
        super().__init__()
        f = in_features
        self.conv1 = nn.Conv2d(f, f // 4, 1)
        self.conv2 = nn.Conv2d(f // 4, f // 4, 3, stride=stride, padding=1)
        self.conv3 = nn.Conv2d(f // 4, f, 1)
        self.norm1 = FrozenBatchNorm(f // 4)
        self.norm2 = FrozenBatchNorm(f // 4)
        self.norm3 = FrozenBatchNorm(f)
        self.stride = stride
        if stride != 1:
            self.skip = nn.Conv2d(f, f, 1, stride=stride)
            self.norm4 = FrozenBatchNorm(f)

    def forward(self, x):
        out = F.relu(self.norm1(self.conv1(x)))
        out = F.relu(self.norm2(self.conv2(out)))
        out = self.norm3(self.conv3(out))
        if self.stride != 1:
            x = self.norm4(self.skip(x))
        return F.relu(out + x)


class ResBlock3d(nn.Module):
    def __init__(self, in_features):
        super().__init__()
        self.conv1 = nn.Conv3d(in_features, in_features, 3, padding=1)
        self.conv2 = nn.Conv3d(in_features, in_features, 3, padding=1)
        self.norm1 = FrozenBatchNorm(in_features)
        self.norm2 = FrozenBatchNorm(in_features)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return out + x


class _ConvNorm(nn.Module):
    """conv -> frozen BN -> activation, the shape of every Up, Down and Same
    block (``conv``, ``norm``)."""

    def __init__(self, conv, out_features):
        super().__init__()
        self.conv = conv
        self.norm = FrozenBatchNorm(out_features)

    def _act(self, x):
        return F.relu(self.norm(self.conv(x)))


class UpBlock3d(_ConvNorm):
    """nearest (1,2,2) upsample -> conv3d -> BN -> relu."""

    def __init__(self, in_features, out_features):
        super().__init__(nn.Conv3d(in_features, out_features, 3, padding=1),
                         out_features)

    def forward(self, x):
        return self._act(x.repeat_interleave(2, -2).repeat_interleave(2, -1))


class DownBlock2d(_ConvNorm):
    """conv -> BN -> relu -> 2x2 average pool."""

    def __init__(self, in_features, out_features):
        super().__init__(nn.Conv2d(in_features, out_features, 3, padding=1),
                         out_features)

    def forward(self, x):
        return F.avg_pool2d(self._act(x), 2)


class DownBlock3d(_ConvNorm):
    """conv3d -> BN -> relu -> (1,2,2) average pool."""

    def __init__(self, in_features, out_features):
        super().__init__(nn.Conv3d(in_features, out_features, 3, padding=1),
                         out_features)

    def forward(self, x):
        return F.avg_pool3d(self._act(x), (1, 2, 2))


class SameBlock2d(_ConvNorm):
    def __init__(self, in_features, out_features, lrelu=False):
        super().__init__(nn.Conv2d(in_features, out_features, 3, padding=1),
                         out_features)
        self.lrelu = lrelu

    def forward(self, x):
        out = self.norm(self.conv(x))
        return F.leaky_relu(out, 0.01) if self.lrelu else F.relu(out)


class _Encoder3D(nn.Module):
    def __init__(self, block_expansion, in_features, num_blocks, max_features):
        super().__init__()
        self.down_blocks = nn.ModuleList(
            DownBlock3d(in_features if i == 0 else
                        min(max_features, block_expansion * 2 ** i),
                        min(max_features, block_expansion * 2 ** (i + 1)))
            for i in range(num_blocks))

    def forward(self, x):
        outs = [x]
        for blk in self.down_blocks:
            outs.append(blk(outs[-1]))
        return outs


class _Decoder3D(nn.Module):
    def __init__(self, block_expansion, in_features, num_blocks, max_features):
        super().__init__()
        ups = []
        for i in reversed(range(num_blocks)):
            in_f = (1 if i == num_blocks - 1 else 2) * min(
                max_features, block_expansion * 2 ** (i + 1))
            ups.append(UpBlock3d(in_f, min(max_features, block_expansion * 2 ** i)))
        self.up_blocks = nn.ModuleList(ups)
        self.out_filters = block_expansion + in_features
        self.conv = nn.Conv3d(self.out_filters, self.out_filters, 3, padding=1)
        self.norm = FrozenBatchNorm(self.out_filters)

    def forward(self, outs):
        out = outs.pop()
        for blk in self.up_blocks:
            out = torch.cat([blk(out), outs.pop()], dim=1)
        return F.relu(self.norm(self.conv(out)))


class Hourglass3D(nn.Module):
    """3-D hourglass with skip concatenation (``encoder``, ``decoder``)."""

    def __init__(self, block_expansion, in_features, num_blocks=3,
                 max_features=256):
        super().__init__()
        self.encoder = _Encoder3D(block_expansion, in_features, num_blocks,
                                  max_features)
        self.decoder = _Decoder3D(block_expansion, in_features, num_blocks,
                                  max_features)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))


class KPHourglass(nn.Module):
    """2-D down path -> 1x1 conv -> reshape to 3-D -> 3-D up path."""

    def __init__(self, block_expansion, in_features, reshape_features,
                 reshape_depth, num_blocks=3, max_features=256):
        super().__init__()
        self.down_blocks = nn.Sequential()
        for i in range(num_blocks):
            self.down_blocks.add_module(f"down{i}", DownBlock2d(
                in_features if i == 0 else
                min(max_features, block_expansion * 2 ** i),
                min(max_features, block_expansion * 2 ** (i + 1))))
        in_f = min(max_features, block_expansion * 2 ** num_blocks)
        self.conv = nn.Conv2d(in_f, reshape_features, 1)
        self.up_blocks = nn.Sequential()
        for i in range(num_blocks):
            in_f = min(max_features, block_expansion * 2 ** (num_blocks - i))
            out_f = min(max_features, block_expansion * 2 ** (num_blocks - i - 1))
            self.up_blocks.add_module(f"up{i}", UpBlock3d(in_f, out_f))
        self.reshape_depth = reshape_depth

    def forward(self, x):
        out = self.conv(self.down_blocks(x))
        bs, c, h, w = out.shape
        out = out.reshape(bs, c // self.reshape_depth, self.reshape_depth, h, w)
        return self.up_blocks(out)


class AntiAliasInterpolation2d(nn.Module):
    """Gaussian pre-filter then a strided pick; the filter is the buffer
    ``weight`` [C,1,k,k] (a key of the reference's checkpoint)."""

    def __init__(self, channels, scale):
        super().__init__()
        self.channels, self.scale = channels, scale
        sigma = (1 / scale - 1) / 2
        self.ksize = 2 * round(sigma * 4) + 1
        self.ka = self.ksize // 2
        self.kb = self.ka - 1 if self.ksize % 2 == 0 else self.ka
        self.register_buffer("weight", self._kernel())

    def _kernel(self):
        sigma = (1 / self.scale - 1) / 2
        grid = np.arange(self.ksize, dtype=np.float32)
        k1 = np.exp(-((grid - (self.ksize - 1) / 2) ** 2) / (2 * sigma ** 2))
        k2 = np.outer(k1, k1)
        k2 = (k2 / k2.sum()).astype(np.float32)
        return torch.from_numpy(k2)[None, None].repeat(self.channels, 1, 1, 1)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(self._kernel())

    def forward(self, x):
        if self.scale == 1.0:
            return x
        out = F.pad(x, (self.ka, self.kb, self.ka, self.kb))
        out = F.conv2d(out, self.weight.to(x.dtype), groups=self.channels)
        inv = int(1 / self.scale)
        return out[:, :, ::inv, ::inv]


class SPADE(nn.Module):
    """InstanceNorm(x) * (1 + gamma(seg)) + beta(seg), seg resized (nearest)
    to x."""

    def __init__(self, norm_nc, label_nc, nhidden=128):
        super().__init__()
        self.param_free_norm = InstanceNorm()
        self.mlp_shared = nn.Sequential(
            nn.Conv2d(label_nc, nhidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, 3, padding=1)

    def forward(self, x, segmap):
        normalized = self.param_free_norm(x)
        actv = self.mlp_shared(nearest_resize(segmap, x.shape[-2:]))
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin, fout, label_nc):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = SNConv2d(fin, fmiddle, 3, padding=1)
        self.conv_1 = SNConv2d(fmiddle, fout, 3, padding=1)
        self.norm_0 = SPADE(fin, label_nc)
        self.norm_1 = SPADE(fmiddle, label_nc)
        if self.learned_shortcut:
            self.conv_s = SNConv2d(fin, fout, 1, bias=False)
            self.norm_s = SPADE(fin, label_nc)

    def forward(self, x, seg):
        x_s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx
