"""Gram-matrix style loss over VGG16 activations (counterpart of
``e4s_tpu/criteria/style_loss.py``): both images at 256^2, optionally
re-normalised from [-1,1] to ImageNet statistics and masked to a region,
the l2 (or l1) distance of the Gram matrices at VGG16 positions 3, 8, 15
and 22, averaged."""

from __future__ import annotations

import torch.nn as nn

from e4s_tpu_torch.models.lpips_nets import VGG16Activations
from e4s_tpu_torch.ops.resize import bilinear_resize

VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)


def gram_matrix(x):
    """[N,C,H,W] -> [N*C, N*C] / (N*H*W*C)."""
    N, C, H, W = x.shape
    flat = x.reshape(N * C, H * W)
    return (flat @ flat.t()) / (N * H * W * C)


class StyleLoss(nn.Module):
    """forward(x, x_hat, mask_x=None, mask_x_hat=None) -> the loss. The
    trunk ``vgg16_act`` takes torchvision's ``vgg16().features`` weights."""

    def __init__(self, normalize: bool = True, distance: str = "l2"):
        super().__init__()
        self.normalize = normalize
        self.distance = distance
        self.vgg16_act = VGG16Activations()

    def _normalize_img(self, x):
        mean = x.new_tensor(VGG_MEAN).reshape(1, 3, 1, 1)
        std = x.new_tensor(VGG_STD).reshape(1, 3, 1, 1)
        return ((x + 1) / 2 - mean) / std

    def forward(self, x, x_hat, mask_x=None, mask_x_hat=None):
        x = bilinear_resize(x, (256, 256))
        x_hat = bilinear_resize(x_hat, (256, 256))
        if self.normalize:
            x, x_hat = self._normalize_img(x), self._normalize_img(x_hat)
        if mask_x is not None:
            H, W = x.shape[2:]
            x = x * bilinear_resize(mask_x, (H, W))
            x_hat = x_hat * bilinear_resize(mask_x_hat, (H, W))
        loss = 0.0
        acts_x, acts_x_hat = self.vgg16_act(x), self.vgg16_act(x_hat)
        for fx, fxh in zip(acts_x, acts_x_hat):
            d = gram_matrix(fx) - gram_matrix(fxh)
            loss = loss + (d.pow(2).mean() if self.distance == "l2" else d.abs().mean())
        return loss / len(acts_x)
