"""The discriminator's convolutions, with a double backward made of plain
convolutions (the reference's ``conv2d_gradfix``; the JAX package's
``ops/conv.py`` is its XLA shim): ``conv2d`` and the FIR filter ``blur``.

PyTorch's own double backward of ``F.conv2d`` (the R1 penalty's backward)
forms the weight's second-order term as a convolution with the output
gradient as its kernel, as large as the image, and runs a grouped
(depthwise) conv's as a conv per group; through the 1024^2 discriminator
on an H100 that took 9-10 s per R1 step. Here each backward is itself
made of autograd Functions: an input gradient is the convolution of the
other direction, and a weight gradient ``_WeightGrad`` (PyTorch's weight
gradient kernel), whose own backward is again the two convolutions. The
values are those of ``F.conv2d``; only the kernels that compute the
second derivatives differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv(x, w, stride, padding, transpose, output_padding=(0, 0)):
    if transpose:
        return F.conv_transpose2d(x, w, stride=stride, padding=padding,
                                  output_padding=output_padding)
    return F.conv2d(x, w, stride=stride, padding=padding)


def _input_grad(gy, w, x_shape, stride, padding, transpose):
    """The gradient w.r.t. the input of ``_conv(x, w)``: the convolution of
    the other direction (output padding to x's size)."""
    if transpose:
        return _Conv.apply(gy, w, None, stride, padding, False, (0, 0))
    kh, kw = w.shape[-2:]
    out_pad = tuple(
        x_shape[2 + i] - ((gy.shape[2 + i] - 1) * stride[i] - 2 * padding[i] + k)
        for i, k in enumerate((kh, kw)))
    return _Conv.apply(gy, w, None, stride, padding, True, out_pad)


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, transpose, output_padding):
        ctx.save_for_backward(x, w)
        ctx.cfg = (stride, padding, transpose, output_padding)
        ctx.has_bias = bias is not None
        out = _conv(x, w, stride, padding, transpose, output_padding)
        if bias is not None:
            out = out + bias.reshape(1, -1, 1, 1)
        return out

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, transpose, output_padding = ctx.cfg
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = _input_grad(gy, w, x.shape, stride, padding, transpose)
        if ctx.needs_input_grad[1]:
            gw = _WeightGrad.apply(gy, x, w.shape, ctx.cfg)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum(dim=(0, 2, 3))
        return gx, gw, gb, None, None, None, None


class _WeightGrad(torch.autograd.Function):
    """d(output)/d(weight) contracted with ``gy``, for the convolution of
    ``cfg`` with input ``x``."""

    @staticmethod
    def forward(ctx, gy, x, w_shape, cfg):
        ctx.save_for_backward(gy, x)
        ctx.cfg = cfg
        stride, padding, transpose, output_padding = cfg
        w = x.new_empty(w_shape)
        return torch.ops.aten.convolution_backward(
            gy, x, w, None, stride, padding, (1, 1), transpose, output_padding,
            1, (False, True, False))[1]

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        stride, padding, transpose, output_padding = ctx.cfg
        ggy = gx = None
        if ctx.needs_input_grad[0]:
            ggy = _Conv.apply(x, ggw, None, stride, padding, transpose, output_padding)
        if ctx.needs_input_grad[1]:
            gx = _input_grad(gy, ggw, x.shape, stride, padding, transpose)
        return ggy, gx, None, None


def conv2d(x, w, bias=None, stride=1, padding=0):
    """``F.conv2d`` (no groups, no dilation) with a double backward of
    plain convolutions."""
    return _Conv.apply(x, w, bias, _pair(stride), _pair(padding), False, (0, 0))


class _Depthwise(torch.autograd.Function):
    """The FIR ``kernel`` (no gradient) correlated with every channel,
    stride 1, symmetric ``pad``, or its adjoint (``transpose``); each is the
    other's backward."""

    @staticmethod
    def forward(ctx, x, kernel, pad, transpose):
        ctx.save_for_backward(kernel)
        ctx.cfg = (pad, transpose)
        C = x.shape[1]
        w = kernel.to(x.dtype).expand(C, 1, *kernel.shape)
        fn = F.conv_transpose2d if transpose else F.conv2d
        return fn(x, w, padding=pad, groups=C)

    @staticmethod
    def backward(ctx, gy):
        (kernel,) = ctx.saved_tensors
        pad, transpose = ctx.cfg
        return _Depthwise.apply(gy, kernel, pad, not transpose), None, None, None


def blur(x, kernel, pad: int):
    """``upfirdn2d(x, kernel, pad=(pad, pad))`` (the FIR filter, stride 1):
    x [B,C,H,W]; kernel [kh,kw], convolved (applied flipped)."""
    return _Depthwise.apply(x, torch.flip(kernel, (0, 1)), pad, False)
