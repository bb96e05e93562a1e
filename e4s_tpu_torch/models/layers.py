"""Equalised-learning-rate building blocks (counterpart of
``e4s_tpu/models/layers.py``). Parameter names and shapes are the
reference's, so its checkpoints load with ``load_state_dict``.

Every module with parameters has ``reset_parameters(generator)``, which
draws its own (not its children's) initial values from an explicit
``torch.Generator``; ``init_module_`` walks a model with it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from e4s_tpu_torch.ops.conv import blur, conv2d
from e4s_tpu_torch.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from e4s_tpu_torch.ops.upfirdn2d import make_kernel


def pixel_norm(x, eps: float = 1e-8):
    return x * torch.rsqrt(torch.mean(x ** 2, dim=1, keepdim=True) + eps)


class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class EqualLinear(nn.Module):
    """Linear with equalised lr and optional fused leaky-relu."""

    def __init__(self, in_dim, out_dim, bias=True, bias_init=0.0, lr_mul=1.0,
                 activation=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None
        self.bias_init = bias_init
        self.lr_mul = lr_mul
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.activation = activation

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.normal_(generator=generator).div_(self.lr_mul)
            if self.bias is not None:
                self.bias.fill_(self.bias_init)

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        if self.bias is not None:
            out = out + self.bias * self.lr_mul
        return out


class EqualConv2d(nn.Module):
    """Conv2d with equalised lr (``ops/conv.py::conv2d``, whose double
    backward, the R1 penalty's, is plain convolutions)."""

    def __init__(self, in_channel, out_channel, kernel_size, stride=1,
                 padding=0, bias=True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channel, in_channel, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channel)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.stride = stride
        self.padding = padding

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return conv2d(x, self.weight * self.scale, bias=self.bias,
                      stride=self.stride, padding=self.padding)


class FusedLeakyReLU(nn.Module):
    """Learned per-channel bias + leaky relu + sqrt(2) gain."""

    def __init__(self, channel, negative_slope=0.2, scale=math.sqrt(2.0)):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(channel))
        self.negative_slope = negative_slope
        self.scale = scale

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)


class ScaledLeakyReLU(nn.Module):
    """LeakyReLU with the sqrt(2) gain and no bias."""

    def forward(self, x):
        return scaled_leaky_relu(x)


class Blur(nn.Module):
    """The FIR filter with the symmetric padding ``pad`` as a module
    (``ops/conv.py::blur``, whose double backward, the R1 penalty's, is
    plain convolutions): the 2-D kernel is the buffer ``kernel`` (a key of
    the reference's checkpoints)."""

    def __init__(self, taps, pad):
        super().__init__()
        if pad[0] != pad[1]:
            raise ValueError(f"Blur takes a symmetric padding, not {pad}")
        self.taps = tuple(taps)
        self.pad = pad[0]
        self.register_buffer("kernel", make_kernel(self.taps))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.kernel.copy_(make_kernel(self.taps))

    def forward(self, x):
        return blur(x, self.kernel, self.pad)


class ConvLayer(nn.Sequential):
    """[Blur, stride 2 when ``downsample``] -> EqualConv2d -> [activation]:
    the discriminator's layer, with the reference's Sequential indices. The
    conv carries the bias only without an activation; the activation is
    ``FusedLeakyReLU`` (with the bias) or, without one, ``ScaledLeakyReLU``."""

    def __init__(self, in_channel, out_channel, kernel_size, downsample=False,
                 blur_kernel=(1, 3, 3, 1), bias=True, activate=True):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, pad=((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size,
                                  stride=stride, padding=padding,
                                  bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channel) if bias else ScaledLeakyReLU())
        super().__init__(*layers)


def init_module_(root: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter and buffer of ``root`` from ``generator``,
    in module order, so a seed gives the same weights on every device (draw
    on the CPU, then move). Modules of this package define
    ``reset_parameters(generator)``; ``nn.Conv2d``, ``nn.ConvTranspose2d``,
    ``nn.Linear``, ``nn.PReLU``, ``nn.LayerNorm`` and ``nn.GroupNorm`` get
    PyTorch's own defaults (uniform in +-1/sqrt(fan_in) for the first
    three, as PyTorch computes fan_in from the weight's dims 1 and up)."""
    for m in root.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.PReLU):
            with torch.no_grad():
                m.weight.fill_(0.25)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.reset_parameters()
        elif type(m).__module__.startswith("e4s_tpu_torch.") and hasattr(
            m, "reset_parameters"
        ):
            m.reset_parameters(generator)
    return root
