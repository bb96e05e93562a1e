"""Plain 3x3 convolution, stride 1, zero padding 1, NHWC, float32: the
hand-written CUDA kernel, its wrapper and its plain version.

    out[b,h,w,o] = sum_{ty,tx,i} w[o,i,ty,tx] * x[b,h+ty-1,w+tx-1,i]

x: [B,H,W,Ci]; w: [Co,Ci,3,3] (OIHW, as ``nn.Conv2d`` keeps it). The
stride-1 3x3 convs of the port's IR-SE trunks (``models/encoders.py::
Conv3x3``) take it on the card in float32.

Replaces no TPU kernel (the JAX package leaves these convs to XLA): on an
H100 with TF32 off, cuDNN runs them on its f32 SIMT kernels. The kernel
(``csrc/conv3_tf32.cu``) is the masked conv's f32 kernel (``ops/
patch_modconv.py``) without its style and demodulation maps: an implicit
GEMM on the tensor cores in the 3xTF32 split (f32-like accuracy), both
operands read by wgmma from shared memory, split K with a fixed-order
second pass for small grids. It takes the masked conv's packed f32 weight
(``patch_modconv.pack_weight``; the model packs each weight once and keeps
it). ``ops/kernel_lib.py`` builds the source into its own library.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from e4s_tpu_torch.ops import kernel_lib
from e4s_tpu_torch.ops import patch_modconv as pmc
from e4s_tpu_torch.ops.kernel_lib import INT, PTR

_ENTRIES = {"conv3x3_tf32": [PTR] * 4 + [INT] * 8 + [PTR]}  # of the .cu
TILE_K = pmc.TILE_K[torch.float32]  # input channels of a K step
# pixel tiles the kernel has, in the order the plan prefers them on a tie
TILES = ((16, 16), (8, 16), (8, 8))


def conv3x3_nhwc_plain(x, w):
    """``F.conv2d`` on the NCHW view of x, returned as an NHWC view."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def kernel_takes(device, dtype, stride, ci) -> bool:
    """Whether a 3x3, padding-1 conv of ``ci`` input channels at ``stride``
    (an int or a pair) on an input of ``device`` and ``dtype`` goes to the
    kernel: a CUDA float32 input, stride 1, and ``ci`` a multiple of 4 (one
    16-byte copy)."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and stride in (1, (1, 1)) and ci % 4 == 0)


@functools.lru_cache(maxsize=None)
def plan(B, H, W, Ci, Co, sms=132):
    """(tile rows, tile columns, K splits) for one launch. For each pixel
    tile the splits double while the grid stays within one wave of ``sms``
    blocks (one block fits an SM) and each split keeps >= 4 K steps of 8
    channels; the plan takes the tile with the least waves x (K steps a
    split + 2 to fill and drain) x max(tile pixels, 160). Every step brings
    the same 72 KB weight tile, so a step of a smaller tile costs no less
    than ~160 pixels' worth: it wins only where it saves waves or tiles
    past the image. At each shape of the encoder, B = 2 and 16, the pick is
    the fastest plan or within 2% of it (``scripts/sweep_conv3_plans.py``)."""
    steps = -(-Ci // TILE_K)
    best = None
    for th, tw in TILES:
        blocks = B * -(-H // th) * -(-W // tw) * -(-Co // pmc.TILE_N)
        splits = 1
        while blocks * splits * 2 <= sms and steps >= 4 * splits * 2:
            splits *= 2
        waves = -(-blocks * splits // sms)
        cost = waves * (-(-steps // splits) + 2) * max(th * tw, 160)
        if best is None or cost < best[0]:
            best = (cost, (th, tw, splits))
    return best[1]


def _launch(x, w, packed=None):
    """One kernel launch (plus the split-K sum where the plan splits)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x [B,H,W,Ci] and w [Co,Ci,3,3], not {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    B, H, W, Ci = x.shape
    Co = w.shape[0]
    dev = x.device
    kernel_lib.check("x", x, (B, H, W, Ci), dev, torch.float32)
    if tuple(w.shape) != (Co, Ci, 3, 3):
        raise ValueError(f"w has shape {tuple(w.shape)}, want {(Co, Ci, 3, 3)}")
    if w.dtype != torch.float32:
        raise TypeError(f"w is {w.dtype}, x float32: the kernel casts nothing")
    if w.device != dev:
        raise ValueError(f"w is on {w.device}, x on {dev}")
    if Ci % 4:
        raise ValueError(f"Ci={Ci}: the kernel takes a multiple of 4 "
                         "(16-byte copies)")
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    if packed is None:
        packed = pmc.pack_weight(w)
    kernel_lib.check("packed weight", packed, pmc.packed_shape(1, Co, Ci), dev,
                     torch.float32)
    fn = kernel_lib.load("conv3_tf32", _ENTRIES).conv3x3_tf32
    out = torch.empty((B, H, W, Co), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        th, tw, splits = plan(B, H, W, Ci, Co, kernel_lib.sm_count(dev))
        part = None
        if splits > 1:
            part = torch.empty((splits, *out.shape), dtype=torch.float32,
                               device=dev)
        err = fn(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(),
                 B, H, W, Ci, Co, th, tw, splits, stream)
    kernel_lib.check_launch("conv3x3_tf32", err)
    conv3x3_nhwc.launches += 1
    return out


def conv3x3_nhwc(x, w, packed=None):
    """Plain 3x3 conv, stride 1, padding 1: x [B,H,W,Ci] -> [B,H,W,Co]. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (building it on first use) or raises; a gradient goes through the plain
    version (``kernel_lib.PlainGrad``). ``packed``: ``pack_weight(w)`` kept
    by the caller, or None."""
    if x.device.type == "cpu":
        return conv3x3_nhwc_plain(x, w)
    return kernel_lib.with_plain_grad(_launch, conv3x3_nhwc_plain, (x, w), packed)


# Kernel launches since the last reset; a run sets it to 0 before the path
# it wants to account for and reads it after.
conv3x3_nhwc.launches = 0
