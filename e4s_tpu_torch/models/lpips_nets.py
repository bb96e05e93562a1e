"""LPIPS perceptual distance (v0.1) on AlexNet or VGG16 features
(counterpart of ``e4s_tpu/models/lpips_nets.py``).

The feature trunks are torchvision's ``alexnet().features`` and
``vgg16().features`` layer for layer, so their state_dicts have the same
keys (``0.weight``, ``3.weight``, ...) and a torchvision checkpoint's
``features.*`` loads into ``LPIPS.net``; the 1x1 heads are the LPIPS
release's ``lin`` layers (``lin.{i}.1.weight``, [1,C,1,1]).
"""

from __future__ import annotations

import torch
import torch.nn as nn

# LPIPS' input scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ALEX_CHANNELS = (64, 192, 384, 256, 256)
VGG_CHANNELS = (64, 128, 256, 512, 512)
VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
           512, 512, 512, "M")


def _normalize_activation(x, eps=1e-10):
    """Unit length along channels."""
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


class _Features(nn.Sequential):
    """A torchvision ``features`` stack that returns the unit-normalised
    outputs of the ReLUs at ``TAPS`` (positions in the stack)."""

    TAPS: tuple = ()

    def forward(self, x):
        shift = x.new_tensor(_SHIFT).reshape(1, 3, 1, 1)
        scale = x.new_tensor(_SCALE).reshape(1, 3, 1, 1)
        x = (x - shift) / scale
        taps = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in self.TAPS:
                taps.append(_normalize_activation(x))
                if i == self.TAPS[-1]:
                    break
        return taps


class AlexNetFeatures(_Features):
    """torchvision ``alexnet().features``; taps at its five ReLUs."""

    TAPS = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2),
        )


class VGG16Features(_Features):
    """torchvision ``vgg16().features``; taps at the ReLU ending each of its
    five stages."""

    TAPS = (3, 8, 15, 22, 29)

    def __init__(self):
        layers, c = [], 3
        for entry in VGG_CFG:
            if entry == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c, entry, 3, padding=1), nn.ReLU()]
                c = entry
        super().__init__(*layers)


class VGG16Activations(nn.Sequential):
    """torchvision ``vgg16().features`` up to position 22: the raw ReLU
    outputs at positions 3, 8, 15 and 22 (the style loss's trunk; no input
    scaling, no normalisation). A torchvision ``features`` state_dict loads
    with ``strict=False`` (the deeper layers are not held)."""

    TAPS = (3, 8, 15, 22)

    def __init__(self):
        super().__init__(*list(VGG16Features())[:self.TAPS[-1] + 1])

    def forward(self, x):
        taps = []
        for i, layer in enumerate(self):
            x = layer(x)
            if i in self.TAPS:
                taps.append(x)
        return taps


class LinHead(nn.Module):
    """An LPIPS head: the weight [1,C,1,1] of a 1x1 conv without bias (ones
    when initialised, as in the JAX package)."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, channels, 1, 1))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)


class LPIPS(nn.Module):
    """forward(x, y) with x, y [B,3,H,W] in [-1,1] -> the batch mean of the
    LPIPS distance: per tap, the channel sum of the head-weighted squared
    difference of unit-normalised features, averaged over pixels, summed
    over taps."""

    def __init__(self, net_type: str = "alex"):
        super().__init__()
        if net_type == "alex":
            self.net, channels = AlexNetFeatures(), ALEX_CHANNELS
        elif net_type == "vgg":
            self.net, channels = VGG16Features(), VGG_CHANNELS
        else:
            raise ValueError(f"unknown LPIPS network {net_type!r}")
        self.lin = nn.ModuleList([
            nn.Sequential(nn.Identity(), LinHead(c)) for c in channels])

    def forward(self, x, y):
        total = 0.0
        for ax, ay, lin in zip(self.net(x), self.net(y), self.lin):
            w = lin[1].weight.to(ax.dtype)
            total = total + torch.mean(
                torch.sum((ax - ay) ** 2 * w, dim=1), dim=(1, 2))
        return torch.sum(total) / x.shape[0]
