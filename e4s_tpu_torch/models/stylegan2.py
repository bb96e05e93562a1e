"""Mask-guided StyleGAN2 generator and the StyleGAN2 discriminator
(counterpart of ``e4s_tpu/models/stylegan2.py``).

Layers below K = ``remaining_layer_idx`` take one style per facial region
and run the region-masked modulated conv (``ops/modconv.py``, the CUDA
kernel on a GPU); layers from K on take the shared style ``latent[:, 0, i]``
and run the plain modulated conv. Schedule for out_size=1024, K=13:

  conv1 (4^2)        masked     style idx 0
  to_rgb1 (4^2)      masked     style idx 1
  scale s=3..10 (8^2..1024^2), layer indices i = 2s-5, 2s-4:
    convs masked iff s <= 2 + K//2 (i.e. i < K)
    to_rgbs masked iff s < 2 + K//2 or K == 17

The synthesis activations are NCHW-shaped in channels-last memory; the
public inputs and outputs (images, noise buffers) are NCHW.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from e4s_tpu_torch.models.layers import (
    ConvLayer,
    EqualLinear,
    FusedLeakyReLU,
    PixelNorm,
)
from e4s_tpu_torch.ops.modconv import (
    masked_conv_weights,
    masked_modulated_conv2d,
    masked_torgb,
    modulated_conv2d,
)
from e4s_tpu_torch.ops import styled_conv
from e4s_tpu_torch.ops.kernel_lib import cached
from e4s_tpu_torch.ops.upfirdn2d import make_kernel, upsample2


def generator_channels(channel_multiplier: int = 2, ch_div: int = 1):
    """Channels per resolution. ``ch_div`` narrows every stage (to at least
    8), as the JAX package's knob of the same name does for small test
    models; 1, the default, is the published width."""
    base = {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }
    return {k: max(8, v // ch_div) for k, v in base.items()}


class _FirKernel(nn.Module):
    """Holds the scaled 2-D FIR kernel as the buffer ``kernel`` (the
    reference's Blur / Upsample modules, which carry no parameters)."""

    def __init__(self, taps, gain):
        super().__init__()
        self.taps = tuple(taps)
        self.gain = gain
        self.register_buffer("kernel", make_kernel(self.taps) * gain)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.kernel.copy_(make_kernel(self.taps) * self.gain)


class ModulatedConv2d(nn.Module):
    """Weight-modulated conv with the masked regional variant."""

    def __init__(self, in_channel, out_channel, kernel_size, style_dim,
                 demodulate=True, upsample=False, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(1, out_channel, in_channel, kernel_size, kernel_size)
        )
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.upsample = upsample
        self.blur_kernel = tuple(blur_kernel)
        if upsample:
            self.blur = _FirKernel(blur_kernel, 4.0)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def _masked_weights(self, w_scaled):
        """The masked conv kernel's weights (the 3x3 or up-phase weights and
        their packed layout), kept by ``kernel_lib.cached``."""
        return cached(self, (self.weight,), lambda: masked_conv_weights(
            w_scaled, self.upsample, self.blur_kernel))

    def forward(self, x, style, mask=None):
        """style: [B, style_dim], or [B, R, style_dim] with the one-hot
        ``mask`` [B, R, Hm, Wm] for regional injection."""
        w_scaled = self.weight[0] * self.scale
        s = self.modulation(style)
        if mask is None:
            return modulated_conv2d(
                x, w_scaled, s, demodulate=self.demodulate, up=self.upsample,
                blur_kernel=self.blur.kernel if self.upsample else self.blur_kernel,
            )
        if self.kernel_size == 1 and not self.demodulate and not self.upsample:
            return masked_torgb(x, w_scaled, s, mask)
        return masked_modulated_conv2d(
            x, w_scaled, s, mask, demodulate=self.demodulate, up=self.upsample,
            blur_kernel=self.blur_kernel, weights=self._masked_weights(w_scaled),
        )


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.zero_()

    def forward(self, x, noise):
        """noise: [B or 1, 1, H, W]; None adds nothing."""
        if noise is None:
            return x
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class StyledConv(nn.Module):
    """ModulatedConv + noise + fused bias/act, with the mask-guided option.
    Unmasked, the layer is ``ops/styled_conv.py``'s: one launch of its
    kernel on a CUDA float32 input with grad mode off, else its plain
    version (the same composition of these modules' functions)."""

    def __init__(self, in_channel, out_channel, kernel_size, style_dim,
                 upsample=False, blur_kernel=(1, 3, 3, 1), demodulate=True,
                 mask_op=False):
        super().__init__()
        self.conv = ModulatedConv2d(
            in_channel, out_channel, kernel_size, style_dim,
            demodulate=demodulate, upsample=upsample, blur_kernel=blur_kernel,
        )
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)
        self.mask_op = mask_op

    def forward(self, x, style, mask, noise=None):
        conv = self.conv
        if self.mask_op:
            return self.activate(self.noise(conv(x, style, mask=mask), noise))
        w_scaled = conv.weight[0] * conv.scale
        tensors = (x, w_scaled, conv.modulation(style), noise, self.noise.weight,
                   self.activate.bias)
        blur = conv.blur.kernel if conv.upsample else conv.blur_kernel
        if styled_conv.kernel_takes(x, noise, conv.kernel_size, conv.demodulate,
                                    conv.upsample, conv.blur_kernel, torch.is_grad_enabled()):
            packed = cached(self, (conv.weight,), lambda: styled_conv.styled_conv_weights(
                w_scaled, conv.upsample, conv.blur_kernel))
            return styled_conv.styled_conv3(*tensors, up=conv.upsample, blur_kernel=blur,
                                            packed=packed)
        return styled_conv.styled_conv3_plain(*tensors, up=conv.upsample, blur_kernel=blur,
                                              demodulate=conv.demodulate)


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB, plus the 2x-upsampled skip."""

    def __init__(self, in_channel, style_dim, upsample=True,
                 blur_kernel=(1, 3, 3, 1), mask_op=False):
        super().__init__()
        if upsample:
            self.upsample = _FirKernel(blur_kernel, 4.0)
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(1, 3, 1, 1))
        self.mask_op = mask_op

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, style, mask, skip=None):
        out = self.conv(x, style, mask=mask if self.mask_op else None)
        out = out + self.bias.to(out.dtype)
        if skip is not None:
            out = out + upsample2(skip, self.upsample.kernel)
        return out


class ConstantInput(nn.Module):
    def __init__(self, channel, size=4):
        super().__init__()
        self.input = nn.Parameter(torch.empty(1, channel, size, size))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.input.normal_(generator=generator)


class Generator(nn.Module):
    """Mask-guided StyleGAN2 synthesis network."""

    def __init__(self, size=1024, style_dim=512, n_mlp=8, channel_multiplier=2,
                 blur_kernel=(1, 3, 3, 1), lr_mlp=0.01, split_layer_idx=5,
                 remaining_layer_idx=13, ch_div=1):
        super().__init__()
        channels = generator_channels(channel_multiplier, ch_div)
        self.size = size
        self.style_dim = style_dim
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2
        self.split_layer_idx = split_layer_idx
        self.remaining_layer_idx = remaining_layer_idx
        K = remaining_layer_idx

        self.style = nn.Sequential(
            PixelNorm(),
            *[
                EqualLinear(style_dim, style_dim, lr_mul=lr_mlp,
                            activation="fused_lrelu")
                for _ in range(n_mlp)
            ],
        )
        self.input = ConstantInput(channels[4])
        self.conv1 = StyledConv(channels[4], channels[4], 3, style_dim,
                                blur_kernel=blur_kernel, mask_op=True)
        self.to_rgb1 = ToRGB(channels[4], style_dim, upsample=False,
                             mask_op=True)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channel = channels[4]
        for s in range(3, self.log_size + 1):
            out_channel = channels[2 ** s]
            conv_masked = not (s > 2 + K // 2)
            rgb_masked = not (K != 17 and s >= 2 + K // 2)
            self.convs.append(StyledConv(
                in_channel, out_channel, 3, style_dim, upsample=True,
                blur_kernel=blur_kernel, mask_op=conv_masked,
            ))
            self.convs.append(StyledConv(
                out_channel, out_channel, 3, style_dim,
                blur_kernel=blur_kernel, mask_op=conv_masked,
            ))
            self.to_rgbs.append(ToRGB(out_channel, style_dim,
                                      mask_op=rgb_masked))
            in_channel = out_channel

        # registered per-layer noise (used when randomize_noise=False)
        self.noises = nn.Module()
        for i in range(self.num_layers):
            r = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(f"noise_{i}", torch.empty(1, 1, r, r))

    def reset_parameters(self, generator):
        with torch.no_grad():
            for i in range(self.num_layers):
                getattr(self.noises, f"noise_{i}").normal_(generator=generator)

    def run_style_mlp(self, z):
        """The 8-layer mapping z [N, 512] -> w [N, 512] (pixel norm first)."""
        return self.style(z)

    def mean_latent(self, n_latent: int, generator: Optional[torch.Generator] = None):
        """The mean of ``n_latent`` mapped z ~ N(0, 1): [1, 512]. z is drawn
        from ``generator`` on its device (a CPU generator gives the same z
        for weights on any device), then moved to the weights'."""
        w = self.style[1].weight
        z = torch.randn((n_latent, self.style_dim), generator=generator,
                        device=generator.device if generator is not None else w.device)
        return self.run_style_mlp(z.to(w.device, w.dtype)).mean(dim=0, keepdim=True)

    def forward(
        self,
        styles,
        structure_feats,
        mask,
        return_latents: bool = False,
        input_is_latent: bool = False,
        noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        randomize_noise: bool = True,
        use_structure_code: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """For the E4S path ``styles`` is a one-element list holding the
        W^{r+} latent [B, R, n_latent, 512]; masked layers take
        latent[:, :, i] and shared layers latent[:, 0, i]. A [B, 512] style
        (z, or w with ``input_is_latent``) is broadcast to every layer. With
        ``randomize_noise`` the per-layer noise is drawn from ``generator``
        on the latent's device. Returns (image [B,3,S,S], latent or None,
        features at ``split_layer_idx``)."""
        latent = styles[0] if input_is_latent else self.style(styles[0])
        if latent.ndim < 4:
            latent = latent[:, None, None].expand(-1, 1, self.n_latent, -1)
        B = latent.shape[0]
        if noise is None and randomize_noise:
            noise = [
                torch.randn((B, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2)),
                            generator=generator, device=latent.device,
                            dtype=latent.dtype)
                for i in range(self.num_layers)
            ]
        elif noise is None:
            noise = [getattr(self.noises, f"noise_{i}")
                     for i in range(self.num_layers)]

        out = self.input.input.to(latent.dtype).expand(B, -1, -1, -1)
        out = out.contiguous(memory_format=torch.channels_last)
        out = self.conv1(out, latent[:, :, 0], mask, noise=noise[0])
        skip = self.to_rgb1(out, latent[:, :, 1], mask)

        K = self.remaining_layer_idx
        intermediate_feats = None
        i = 1
        for idx, to_rgb in enumerate(self.to_rgbs):
            conv1, conv2 = self.convs[2 * idx], self.convs[2 * idx + 1]
            noise1, noise2 = noise[1 + 2 * idx], noise[2 + 2 * idx]
            if i < K:
                out = conv1(out, latent[:, :, i], mask, noise=noise1)
                if i + 2 == self.split_layer_idx:
                    if use_structure_code:
                        out = structure_feats.contiguous(
                            memory_format=torch.channels_last)
                    intermediate_feats = out
                out = conv2(out, latent[:, :, i + 1], mask, noise=noise2)
                rgb_style = (latent[:, :, i + 2] if K == 17 or i + 2 != K
                             else latent[:, 0, i + 2])
                skip = to_rgb(out, rgb_style, mask, skip)
            else:
                out = conv1(out, latent[:, 0, i], mask, noise=noise1)
                out = conv2(out, latent[:, 0, i + 1], mask, noise=noise2)
                skip = to_rgb(out, latent[:, 0, i + 2], mask, skip)
            i += 2

        image = skip.contiguous()
        if intermediate_feats is not None:
            intermediate_feats = intermediate_feats.contiguous()
        return image, (latent if return_latents else None), intermediate_feats


class ResBlock(nn.Module):
    """Two 3x3 ConvLayers (the second downsampling) beside a 1x1
    downsampling skip, summed and scaled by 1/sqrt(2)."""

    def __init__(self, in_channel, out_channel, blur_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True,
                               blur_kernel=blur_kernel)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True,
                              blur_kernel=blur_kernel, activate=False,
                              bias=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


class Discriminator(nn.Module):
    """StyleGAN2 discriminator: a 1x1 ConvLayer from RGB, ResBlocks down to
    4^2, the minibatch standard deviation (groups of up to 4 samples, one
    feature) as an extra channel, a 3x3 ConvLayer and two EqualLinears.
    forward(x [B,3,S,S]) -> logits [B,1]."""

    def __init__(self, size=1024, channel_multiplier=2, blur_kernel=(1, 3, 3, 1),
                 ch_div=1):
        super().__init__()
        channels = generator_channels(channel_multiplier, ch_div)
        convs = [ConvLayer(3, channels[size], 1)]
        in_channel = channels[size]
        for i in range(int(math.log2(size)), 2, -1):
            out_channel = channels[2 ** (i - 1)]
            convs.append(ResBlock(in_channel, out_channel, blur_kernel))
            in_channel = out_channel
        self.convs = nn.Sequential(*convs)
        self.stddev_group = 4
        self.stddev_feat = 1
        self.final_conv = ConvLayer(in_channel + 1, channels[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 4 * 4, channels[4], activation="fused_lrelu"),
            EqualLinear(channels[4], 1),
        )

    def forward(self, x):
        out = self.convs(x)
        B, C, H, W = out.shape
        group = min(B, self.stddev_group)
        stddev = out.reshape(group, -1, self.stddev_feat, C // self.stddev_feat, H, W)
        stddev = torch.sqrt(stddev.var(0, correction=0) + 1e-8)
        stddev = stddev.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
        stddev = stddev.repeat(group, 1, H, W)
        out = self.final_conv(torch.cat([out, stddev], 1))
        return self.final_linear(out.reshape(B, -1))
