"""GPEN generator: a CNN encoder whose per-scale features are concatenated
into a StyleGAN2 decoder as its "noise" (the reference's FullGenerator and
FullGenerator_SR with ``isconcat``). The modulated convs are unmasked:
``ops/modconv.py``'s ``modulated_conv2d``, shared with the StyleGAN2
generator's upper layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchmark.reference.models.layers import (
    ConvLayer,
    EqualLinear,
    FusedLeakyReLU,
    PixelNorm,
)
from benchmark.reference.models.stylegan2 import ConstantInput, ModulatedConv2d, ToRGB


def gpen_channels(channel_multiplier: int = 2, narrow: float = 1.0):
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow),
        64: int(256 * channel_multiplier * narrow),
        128: int(128 * channel_multiplier * narrow),
        256: int(64 * channel_multiplier * narrow),
        512: int(32 * channel_multiplier * narrow),
        1024: int(16 * channel_multiplier * narrow),
        2048: int(8 * channel_multiplier * narrow),
    }


class NoiseConcat(nn.Module):
    """The reference's NoiseInjection with ``isconcat``: appends
    ``weight * noise`` as channels; no noise appends zeros (deterministic)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.zero_()

    def forward(self, x, noise=None):
        if noise is None:
            return torch.cat([x, torch.zeros_like(x)], dim=1)
        return torch.cat([x, self.weight.to(x.dtype) * noise.to(x.dtype)], dim=1)


class GPENStyledConv(nn.Module):
    def __init__(self, in_channel, out_channel, kernel_size, style_dim,
                 upsample=False):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size,
                                    style_dim, upsample=upsample)
        self.noise = NoiseConcat()
        self.activate = FusedLeakyReLU(out_channel * 2)

    def forward(self, x, style, noise=None):
        return self.activate(self.noise(self.conv(x, style), noise))


class GPENGenerator(nn.Module):
    def __init__(self, size=512, style_dim=512, n_mlp=8, channel_multiplier=2,
                 narrow=1.0, lr_mlp=0.01):
        super().__init__()
        channels = gpen_channels(channel_multiplier, narrow)
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp,
                        activation="fused_lrelu") for _ in range(n_mlp)])
        self.input = ConstantInput(channels[4])
        self.conv1 = GPENStyledConv(channels[4], channels[4], 3, style_dim)
        self.to_rgb1 = ToRGB(channels[4] * 2, style_dim, upsample=False)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channel = channels[4]
        for s in range(3, self.log_size + 1):
            out_channel = channels[2 ** s]
            self.convs.append(GPENStyledConv(in_channel * 2, out_channel, 3,
                                             style_dim, upsample=True))
            self.convs.append(GPENStyledConv(out_channel * 2, out_channel, 3,
                                             style_dim))
            self.to_rgbs.append(ToRGB(out_channel * 2, style_dim))
            in_channel = out_channel

    def forward(self, style, noise):
        """style [B, style_dim] (mapped through ``style``); ``noise``: one
        tensor (or None) per StyledConv, in order. Returns the image."""
        latent = self.style(style)
        out = self.input.input.expand(latent.shape[0], -1, -1, -1).to(latent.dtype)
        out = self.conv1(out, latent, noise[0])
        skip = self.to_rgb1(out, latent, None)
        for i, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * i](out, latent, noise[2 * i + 1])
            out = self.convs[2 * i + 1](out, latent, noise[2 * i + 2])
            skip = to_rgb(out, latent, None, skip)
        return skip


class GPENFullGeneratorSR(nn.Module):
    """Encoder ``ecd0..`` at ``in_size`` (1x1 conv, then stride-2 convs down
    to 4x4) -> ``final_linear`` style -> ``generator`` decoding to
    ``out_size``, the encoder's features as the decoder's concatenated
    noise; the decoder's scales above ``in_size`` get none (the reference's
    FullGenerator_SR). forward(x [B,3,in_size,in_size] in [-1,1]) ->
    [B,3,out_size,out_size]."""

    def __init__(self, in_size=512, out_size=1024, style_dim=512, n_mlp=8,
                 channel_multiplier=2, narrow=1.0):
        super().__init__()
        channels = gpen_channels(channel_multiplier, narrow)
        log_in = int(math.log2(in_size))
        self.n_ecd = log_in - 1
        self.n_top = int(math.log2(out_size)) - log_in
        self.ecd0 = nn.Sequential(ConvLayer(3, channels[in_size], 1))
        in_channel = channels[in_size]
        for i, s in enumerate(range(log_in, 2, -1)):
            out_channel = channels[2 ** (s - 1)]
            setattr(self, f"ecd{i + 1}", nn.Sequential(
                ConvLayer(in_channel, out_channel, 3, downsample=True)))
            in_channel = out_channel
        self.final_linear = nn.Sequential(EqualLinear(
            channels[4] * 4 * 4, style_dim, activation="fused_lrelu"))
        self.generator = GPENGenerator(out_size, style_dim, n_mlp,
                                       channel_multiplier, narrow)

    def forward(self, x):
        noise = [None] * self.n_top
        out = x
        for i in range(self.n_ecd):
            out = getattr(self, f"ecd{i}")(out)
            noise.append(out)
        style = self.final_linear(out.reshape(out.shape[0], -1))
        # each feature twice, reversed, the first dropped
        sched = [n for n in noise for _ in (0, 1)][::-1][1:]
        return self.generator(style, sched)


class GPENFullGenerator(GPENFullGeneratorSR):
    """GPEN at one size (the reference's FullGenerator). forward(x
    [B,3,size,size] in [-1,1]) -> [B,3,size,size]."""

    def __init__(self, size=512, style_dim=512, n_mlp=8, channel_multiplier=2,
                 narrow=1.0):
        super().__init__(size, size, style_dim, n_mlp, channel_multiplier, narrow)
