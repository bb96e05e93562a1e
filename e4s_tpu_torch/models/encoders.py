"""RGI texture encoder FSEncoder_PSP, the ID loss's IR-SE50 backbone and
their IR-SE blocks (counterpart of ``e4s_tpu/models/encoders.py``). Module
trees follow the reference's ``nn.Sequential`` indices, so the state_dict
keys are the reference's (``body.{i}.res_layer.{0..5}``, ``output_layer.4``
...) and ``model_ir_se50.pth`` loads with ``load_state_dict``.

On the card in float32 the units' stride-1 3x3 convs run the hand-written
kernel of ``ops/conv3x3.py`` (``Conv3x3``), and FSEncoderPSP runs its trunk
channels-last, so that each such conv reads and writes NHWC memory with no
copy; its public tensors stay NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from e4s_tpu_torch.ops.conv3x3 import conv3x3_nhwc, kernel_takes
from e4s_tpu_torch.ops.masked_pool import masked_region_mean
from e4s_tpu_torch.ops.kernel_lib import cached
from e4s_tpu_torch.ops.patch_modconv import pack_weight

PReLU = nn.PReLU


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d`` defaults: affine=False, eps=1e-5, no state. A
    channels-last input keeps its layout (``F.instance_norm`` would copy it
    to NCHW and back): the same mean and biased variance over (H, W)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
                memory_format=torch.channels_last):
            var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
            rstd = torch.rsqrt(var + self.eps)
            return torch.addcmul(-mean * rstd, x, rstd)  # one pass over x
        return F.instance_norm(x, eps=self.eps)


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(in, out, 3, stride, 1, bias=False)``, the same parameter
    and state_dict key, that sends what ``ops/conv3x3.py::kernel_takes``
    accepts (a CUDA float32 input, stride 1, Ci a multiple of 4) to the
    hand-written kernel and the rest to ``F.conv2d``. The kernel reads x as
    an NHWC view (free where x is channels-last) and returns a channels-last
    tensor. Its packed weight is kept by ``kernel_lib.cached``."""

    def __init__(self, in_channels, out_channels, stride=1):
        super().__init__(in_channels, out_channels, 3, stride, 1, bias=False)

    def forward(self, x):
        if not kernel_takes(x.device, x.dtype, self.stride, self.in_channels):
            return super().forward(x)
        packed = cached(self, (self.weight,), lambda: pack_weight(self.weight.detach()))
        out = conv3x3_nhwc(x.permute(0, 2, 3, 1).contiguous(), self.weight, packed)
        return out.permute(0, 3, 1, 2)


class FrozenBatchNorm(nn.Module):
    """BatchNorm (2-D or 1-D input) that always uses its running statistics
    (every network with BatchNorm in the port is frozen). Same keys as
    ``nn.BatchNorm2d``: weight, bias, running_mean, running_var,
    num_batches_tracked."""

    def __init__(self, channel, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channel))
        self.bias = nn.Parameter(torch.empty(channel))
        self.register_buffer("running_mean", torch.empty(channel))
        self.register_buffer("running_var", torch.empty(channel))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class SEModule(nn.Module):
    """Squeeze-excitation: global mean, 1x1 down, relu, 1x1 up, sigmoid."""

    def __init__(self, channels, reduction=16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = x.mean(dim=(-2, -1), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class _Subsample(nn.Module):
    """``MaxPool2d(1, stride)``: a strided pick."""

    def __init__(self, stride):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        return x[:, :, :: self.stride, :: self.stride]


class BottleneckIRSE(nn.Module):
    """IR-SE residual unit: ``norm`` "in" is the RGI encoder's variant
    (InstanceNorm, no parameters), "bn" the ID-loss backbone's (frozen
    BatchNorm); without ``use_se`` it is pSp's plain IR unit."""

    def __init__(self, in_channel, depth, stride, norm="in", use_se=True):
        super().__init__()

        def mk_norm(channel):
            return InstanceNorm() if norm == "in" else FrozenBatchNorm(channel)

        if in_channel == depth:
            self.shortcut_layer = _Subsample(stride)
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride, bias=False),
                mk_norm(depth),
            )
        self.res_layer = nn.Sequential(
            mk_norm(in_channel),
            Conv3x3(in_channel, depth),
            PReLU(depth),
            Conv3x3(depth, depth, stride),
            mk_norm(depth),
            *([SEModule(depth, 16)] if use_se else []),
        )

    def forward(self, x):
        return self.res_layer(x) + self.shortcut_layer(x)


def fsencoder_blocks(slim: bool = False):
    """(in, depth, stride) per unit of the RGI encoder trunk; ``slim``: one
    unit per stage (the JAX package's knob for small test models)."""
    blocks = []
    for in_c, depth, n in ((64, 128, 3), (128, 256, 4), (256, 512, 14),
                           (512, 512, 3)):
        blocks.append((in_c, depth, 2))
        blocks += [(depth, depth, 1)] * (0 if slim else n - 1)
    return blocks


class FSEncoderPSP(nn.Module):
    """RGI texture extractor: IN-normalised IR-SE trunk + per-region masked
    mean of three taps. forward(x [B,3,S,S], segmap [B,R,H,W]) ->
    (codes [B,R,1280], structure_feats: zeros [B,512,S/16,S/16])."""

    def __init__(self, num_seg_cls=12, slim=False):
        super().__init__()
        self.num_seg_cls = num_seg_cls
        # the last 256-channel unit and the last two 512-channel units
        self.TAPS = (1, 2, 3) if slim else (6, 20, 23)
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), InstanceNorm(), PReLU(64)
        )
        self.body = nn.Sequential(*[
            BottleneckIRSE(i, d, s) for i, d, s in fsencoder_blocks(slim)
        ])

    def forward(self, x, segmap):
        if x.is_cuda and x.dtype == torch.float32:
            # the trunk channels-last: the convs' NHWC views are free
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.input_layer(x)
        taps = []
        for i, block in enumerate(self.body):
            x = block(x)
            if i in self.TAPS:
                taps.append(x)
        codes = torch.cat(
            [masked_region_mean(t, segmap) for t in taps], dim=-1
        )
        return codes, torch.zeros_like(x, memory_format=torch.contiguous_format)


def irse50_blocks():
    """(in, depth, stride) per unit of the 50-layer IR-SE trunk."""
    blocks = []
    for in_c, depth, n in ((64, 64, 3), (64, 128, 4), (128, 256, 14),
                           (256, 512, 3)):
        blocks.append((in_c, depth, 2))
        blocks += [(depth, depth, 1)] * (n - 1)
    return blocks


def l2_normalize(v):
    """v / ||v|| along dim 1."""
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


class IRSE50Backbone(nn.Module):
    """ArcFace IR-SE50 recognition network at 112^2 (frozen; the ID loss).
    forward(x [B,3,112,112], multi_scale) -> l2-normalised features: the
    flattened outputs of units 2, 6, 20 and 23 and the 512-d embedding with
    ``multi_scale``, else the embedding alone. Keys are the reference's
    (``input_layer.{0,1,2}``, ``body.{i}``, ``output_layer.{0,3,4}``); the
    embedding's BatchNorm1d (``output_layer.4``) carries an affine weight
    and bias as in the reference checkpoint."""

    TAPS = (2, 6, 20, 23)

    def __init__(self):
        super().__init__()
        self.input_layer = nn.Sequential(
            nn.Conv2d(3, 64, 3, 1, 1, bias=False), FrozenBatchNorm(64), PReLU(64))
        self.body = nn.Sequential(*[
            BottleneckIRSE(i, d, s, norm="bn") for i, d, s in irse50_blocks()])
        # BatchNorm2d, Dropout (inactive), Flatten, Linear, BatchNorm1d
        self.output_layer = nn.Sequential(
            FrozenBatchNorm(512), nn.Identity(), nn.Flatten(),
            nn.Linear(512 * 7 * 7, 512), FrozenBatchNorm(512))

    def forward(self, x, multi_scale: bool = True):
        x = self.input_layer(x)
        feats = []
        for i, block in enumerate(self.body):
            x = block(x)
            if multi_scale and i in self.TAPS:
                feats.append(x.reshape(x.shape[0], -1))
        feats.append(self.output_layer(x))
        return [l2_normalize(f) for f in feats]
