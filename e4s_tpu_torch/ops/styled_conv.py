"""The unmasked StyledConv of the E4S generator (the StyleGAN2 layers from K
on) in one launch: the hand-written CUDA kernel, its wrapper and its plain
version.

    out = sqrt2 * lrelu_0.2(modconv(x, W, s) + nw * noise + bias)

modconv is ``ops/modconv.py::modulated_conv2d`` (demodulated, stride 1 or
conv_transpose2 then the 4x4 blur); x: [B,Ci,H,W]; W: [Co,Ci,3,3]; s:
[B,Ci]; noise: [1 or B,1,Ho,Wo] or None; nw: [1]; bias: [Co]. The plain
version is that composition as ``models/stylegan2.py::StyledConv`` wrote it
(``modulated_conv2d`` -> ``NoiseInjection`` -> ``FusedLeakyReLU``).

Replaces no TPU kernel (the JAX package's ``e4s_tpu/ops/modconv.py::
modulated_conv2d`` leaves this conv to XLA): on an H100 with TF32 off each
such layer ran as cuDNN's transposed conv, upfirdn2d's padded copy and
depthwise blur, and five elementwise passes. The kernel
(``csrc/styled_conv3_tf32.cu``) computes the whole layer in one pass over
x, in the 3xTF32 split (f32-like accuracy) on wgmma: the style applied where
each K step's halo is split into TF32 halves, an up layer as its four
polyphase 3x3 convs (``modconv.up_phase_weights``) laid side by side along
N, and d, the noise, the bias, the LeakyReLU and the gain in the epilogue.
``ops/kernel_lib.py`` builds the source into its own library; the model
packs each weight once (``styled_conv_weights``, kept by
``kernel_lib.cached``).
"""

from __future__ import annotations

import functools

import torch

from e4s_tpu_torch.ops import kernel_lib
from e4s_tpu_torch.ops.fused_act import fused_leaky_relu
from e4s_tpu_torch.ops.kernel_lib import INT, PTR
from e4s_tpu_torch.ops.modconv import demod_coeff, modulated_conv2d, up_phase_weights
from e4s_tpu_torch.ops.patch_modconv import pack_weight, packed_shape

_ENTRIES = {"styled_conv3_tf32": [PTR] * 8 + [INT] * 8 + [PTR]}  # of the .cu


def tile_n(Co, up) -> int:
    """The launch's plan: output columns of a block, and with them the
    pixel tile (the C entry derives it). The P * Co columns (P = 4 phases
    for ``up``) go in one block of 32 (16 x 16 pixels) where they fit, else
    in blocks of 64 (8 x 16 pixels). At the four layers of a 1024^2
    synthesis, B = 1 and 8, these two were the fastest of every tile of 8
    or 16 rows and N = 32, 64 or 128 that the kernel was first built with
    (PERF.md, PR 17). The weight is packed for it."""
    return 32 if (4 if up else 1) * Co <= 32 else 64


def kernel_takes(x, noise, kernel_size, demodulate, up, blur_kernel, grad) -> bool:
    """Whether a StyledConv on ``x`` goes to the kernel: a CUDA float32
    input, no noise or one float32 map a pixel ([1 or B,1,Ho,Wo], not the
    edit's full-channel noise), a demodulated 3x3 weight, Ci a multiple of
    4 (one 16-byte copy), for ``up`` a 4-tap blur (the polyphase fold), and
    grad mode off (``grad``: ``torch.is_grad_enabled()``), so that the
    gradient steps of training and inversion run the plain layer and its
    autograd, not the kernel and the plain forward again behind it."""
    return (x.device.type == "cuda" and x.dtype == torch.float32 and not grad
            and (noise is None or (noise.shape[1] == 1 and noise.dtype == torch.float32
                                   and noise.is_contiguous()))
            and kernel_size == 3 and demodulate and x.shape[1] % 4 == 0
            and (not up or len(blur_kernel) == 4))


def styled_conv_weights(w_scaled, up=False, blur_kernel=(1, 3, 3, 1)):
    """The kernel's packed weight for one layer: the 3x3 weight, or for
    ``up`` the four phase weights side by side along N ([4 Co, Ci, 3, 3],
    column phase * Co + o), in blocks of ``tile_n`` columns."""
    Co = w_scaled.shape[0]
    wk = up_phase_weights(w_scaled, blur_kernel).flatten(0, 1) if up else w_scaled
    return pack_weight(wk, tile_n(Co, up))


def styled_conv3_plain(x, w_scaled, s, noise, noise_weight, bias, *, up=False,
                       blur_kernel=(1, 3, 3, 1), demodulate=True):
    """``modulated_conv2d`` -> ``NoiseInjection`` -> ``FusedLeakyReLU``, op
    for op as the modules compute them: the unmasked StyledConv wherever
    the kernel does not run (the CPU, bf16, a gradient)."""
    out = modulated_conv2d(x, w_scaled, s, demodulate=demodulate, up=up,
                           blur_kernel=blur_kernel)
    if noise is not None:
        out = out + noise_weight.to(out.dtype) * noise.to(out.dtype)
    return fused_leaky_relu(out, bias)


def _check_inputs(x, w_scaled, s, noise, noise_weight, bias, up):
    """Raises unless every input is float32 on x's device, of the layer's
    shape and contiguous (x: any memory format)."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B,Ci,H,W], not {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x is {x.dtype}: the kernel takes float32 and casts nothing")
    B, Ci, H, W = x.shape
    Co = w_scaled.shape[0]
    f = 2 if up else 1
    dev, f32 = x.device, torch.float32
    kernel_lib.check("w", w_scaled, (Co, Ci, 3, 3), dev, f32)
    kernel_lib.check("s", s, (B, Ci), dev, f32)
    kernel_lib.check("bias", bias, (Co,), dev, f32)
    if noise is not None:
        if noise.dim() != 4 or noise.shape[0] not in (1, B):
            raise ValueError(f"noise must be [1 or {B},1,{f * H},{f * W}], not "
                             f"{tuple(noise.shape)}")
        kernel_lib.check("noise", noise, (noise.shape[0], 1, f * H, f * W), dev, f32)
        kernel_lib.check("noise weight", noise_weight, (1,), dev, f32)
    if Ci % 4:
        raise ValueError(f"Ci={Ci}: the kernel takes a multiple of 4 (16-byte copies)")


def _launch(x, w_scaled, s, noise, noise_weight, bias, packed, up, blur_kernel):
    """One kernel launch: x [B,Ci,H,W] -> [B,Co,Ho,Wo] in channels-last
    memory. ``packed``: ``styled_conv_weights``, packed here when None."""
    B, Ci, H, W = x.shape
    Co = w_scaled.shape[0]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    if packed is None:
        packed = styled_conv_weights(w_scaled, up, blur_kernel)
    bn = tile_n(Co, up)
    kernel_lib.check("packed weight", packed,
                     packed_shape(1, (4 if up else 1) * Co, Ci, torch.float32, bn),
                     dev, torch.float32)
    xh = x.permute(0, 2, 3, 1).contiguous()  # free for channels-last x
    d = demod_coeff(w_scaled, s).contiguous()
    f = 2 if up else 1
    out = torch.empty((B, f * H, f * W, Co), dtype=torch.float32, device=dev)
    fn = kernel_lib.load("styled_conv3_tf32", _ENTRIES).styled_conv3_tf32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xh.data_ptr(), packed.data_ptr(), s.data_ptr(), d.data_ptr(),
                 bias.data_ptr(), None if noise is None else noise.data_ptr(),
                 None if noise is None else noise_weight.data_ptr(),
                 out.data_ptr(), B, H, W, Ci, Co, int(up),
                 0 if noise is None or noise.shape[0] == 1 else f * H * f * W,
                 bn, stream)
    kernel_lib.check_launch("styled_conv3_tf32", err)
    styled_conv3.launches += 1
    return out.permute(0, 3, 1, 2)


def styled_conv3(x, w_scaled, s, noise, noise_weight, bias, *, up=False,
                 blur_kernel=(1, 3, 3, 1), packed=None):
    """The unmasked StyledConv: x [B,Ci,H,W] -> [B,Co,Ho,Wo] (2x for
    ``up``). Inputs are checked first (float32, one device, the layer's
    shapes: raises otherwise); a CPU tensor then takes the plain version, a
    CUDA tensor launches the kernel (building it on first use), and a
    gradient goes through the plain version (``kernel_lib.PlainGrad``).
    ``blur_kernel``: taps or the scaled 2-D kernel (a module's buffer), as
    ``modulated_conv2d`` takes it; ``packed``: ``styled_conv_weights`` kept
    by the caller, or None."""
    if noise is None:
        noise_weight = None  # unused: no gradient of it
    _check_inputs(x, w_scaled, s, noise, noise_weight, bias, up)
    plain = functools.partial(styled_conv3_plain, up=up, blur_kernel=blur_kernel)
    tensors = (x, w_scaled, s, noise, noise_weight, bias)
    if x.device.type == "cpu":
        return plain(*tensors)
    return kernel_lib.with_plain_grad(_launch, plain, tensors, packed, up, blur_kernel)


# Kernel launches since the last reset; a run sets it to 0 before the path
# it wants to account for and reads it after.
styled_conv3.launches = 0
