"""Adversarial losses and regularisers (counterpart of
``e4s_tpu/criteria/adv_loss.py``). The R1 penalty and the path-length
regulariser take the gradient of D's or G's output with respect to its
input with ``create_graph=True``, so their own backward is a double
backward through D or G."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def adv_g_loss(fake_pred):
    """Non-saturating G loss: mean softplus(-D(fake))."""
    return F.softplus(-fake_pred).mean()


def adv_d_loss(real_pred, fake_pred):
    """mean softplus(-D(real)) + mean softplus(D(fake))."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def d_r1_loss(real_pred, real_img):
    """R1 penalty E[|grad_x D(x)|^2]: ``real_pred`` = D(``real_img``), with
    ``real_img`` requiring a gradient."""
    (grad,) = torch.autograd.grad(real_pred.sum(), real_img, create_graph=True)
    return grad.pow(2).reshape(grad.shape[0], -1).sum(1).mean()


def g_path_regularize(fake_img, latents, mean_path_length, decay=0.01,
                      noise=None, generator=None):
    """Path-length regulariser. ``noise``: a standard normal draw of
    ``fake_img``'s shape, else one from ``generator``; it is scaled by
    1/sqrt(H*W). Returns (penalty, the updated mean path length without a
    gradient, the path lengths [B])."""
    if noise is None:
        noise = torch.randn(fake_img.shape, generator=generator,
                            device=fake_img.device, dtype=fake_img.dtype)
    noise = noise / math.sqrt(fake_img.shape[2] * fake_img.shape[3])
    (grad,) = torch.autograd.grad((fake_img * noise).sum(), latents,
                                  create_graph=True)
    path_lengths = torch.sqrt(grad.pow(2).sum(2).mean(1))
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    path_penalty = (path_lengths - path_mean).pow(2).mean()
    return path_penalty, path_mean.detach(), path_lengths
