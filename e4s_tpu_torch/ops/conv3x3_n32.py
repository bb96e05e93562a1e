"""3x3 convolution with 32 output channels, stride 1, padding 1, NHWC,
float32, with RealESRNet's epilogues: the hand-written CUDA kernel, its
wrapper and its plain version.

    y = bias + conv3x3(x[..., :ci], w)   (x through a nearest 2x upsample: up)
    y = leaky_relu(y, 0.2)               (lrelu)
    y = y * a1 + r1[..., :32]            (r1)
    y = y * a2 + r2[..., :32]            (r2)
    out[..., oc:oc + 32] = y

x, out, r1, r2 are contiguous NHWC float32 buffers, each possibly wider than
what a conv reads or writes of it. A residual dense block of RealESRNet
(``models/gpen/rrdbnet.py``) is then one [B,H,W,160] buffer in which conv k
reads channels [0, 32k) and writes [32k, 32k+32): the concatenations are
never made, and the LeakyReLU and residual passes are part of the conv.

A ``Step`` names its buffers by their index in a list, so that a table of
steps (the whole RRDB trunk and the up path, 349 convs) runs as one call of
the C entry: ``run(steps, bufs, weights, biases, packed)``.

Replaces no TPU kernel (the JAX package's RRDBNet leaves its convs to XLA):
on an H100 with TF32 off, cuDNN ran them on its f32 SIMT kernels. The kernel
(``csrc/conv3_n32_f32.cu``) computes every output as cuDNN does, one chain
of fused multiply-adds over the input channels, tap rows and tap columns,
so its results are cuDNN's bit for bit; the source note gives its design.
It takes each weight packed for its loads (``pack_weight``, made once per
weight by ``pack``); ``ops/kernel_lib.py`` builds it into its own library.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from e4s_tpu_torch.ops import kernel_lib
from e4s_tpu_torch.ops.kernel_lib import INT, PTR

_ENTRIES = {"conv3_n32_run": [PTR, PTR, INT, PTR, PTR, INT, INT] + [PTR] * 5}  # of the .cu
CO = 32  # output channels of every conv the kernel takes
TILE_K = 8  # input channels of a stage


class Step(NamedTuple):
    """One conv of a table: buffer ``x``'s channels [0, ci) in, buffer
    ``out``'s channels [oc, oc + 32) out; ``r1``, ``r2``: buffer indices of
    the residuals (channels [0, 32)) or None."""

    x: int
    ci: int
    out: int
    oc: int = 0
    up: bool = False
    lrelu: bool = False
    r1: int | None = None
    a1: float = 1.0
    r2: int | None = None
    a2: float = 1.0


class Packed(NamedTuple):
    """A table of steps as the C entry reads it, and its weights packed."""

    steps: np.ndarray   # int32 [n, 8]: x, ci, up, out, oc, r1, r2, lrelu
    alphas: np.ndarray  # float32 [n, 2]: a1, a2
    woff: np.ndarray    # int64 [n]: each weight's offset in ``wpack``
    lci: np.ndarray     # int32 [n]: each weight's input channels
    wpack: torch.Tensor  # float32, every ``pack_weight`` one after another
    bias: torch.Tensor   # float32 [n, 32]


def kernel_takes(device, dtype, grad_enabled, ci) -> bool:
    """Whether convs of ``ci`` input channels on an input of ``device`` and
    ``dtype`` go to the kernel: a CUDA float32 input, no gradient wanted (the
    kernel has no backward), and ``ci`` a multiple of 4 (one 16-byte copy)."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and not grad_enabled and ci % 4 == 0)


def conv_plain(x, w, b, up=False, lrelu=False, r1=None, a1=1.0, r2=None, a2=1.0):
    """One step's value [B,H,W,32]: ``F.conv2d`` on x (NHWC, every channel
    read) made NCHW, as ``RRDBNet``'s modules give it their concatenation,
    the epilogue as separate operations; an NHWC view of the result."""
    if up:
        x = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    y = F.conv2d(x.permute(0, 3, 1, 2).contiguous(), w, b, padding=1).permute(0, 2, 3, 1)
    if lrelu:
        y = F.leaky_relu(y, 0.2)
    if r1 is not None:
        y = y * a1 + r1
    if r2 is not None:
        y = y * a2 + r2
    return y


def run_plain(steps, bufs, weights, biases):
    """The steps in order, each by ``conv_plain`` on views of the buffers."""
    for s, w, b in zip(steps, weights, biases, strict=True):
        res = [None if r is None else bufs[r][..., :CO] for r in (s.r1, s.r2)]
        bufs[s.out][..., s.oc:s.oc + CO] = conv_plain(
            bufs[s.x][..., :s.ci], w, b, s.up, s.lrelu, res[0], s.a1, res[1], s.a2)


def pack_weight(w):
    """OIHW [32,Ci,3,3] float32 -> the kernel's layout [Ci, tap row, tap
    column, 32], Ci zero-padded to whole stages of 8 input channels: the
    weights of one input channel and tap row for all 32 outputs lie
    together."""
    if w.dtype != torch.float32 or w.dim() != 4 or (w.shape[0], *w.shape[2:]) != (CO, 3, 3):
        raise ValueError(f"want a float32 [32,Ci,3,3] weight, not {w.dtype} "
                         f"{tuple(w.shape)}")
    ci = w.shape[1]
    t = w.permute(1, 2, 3, 0)
    return F.pad(t, (0, 0, 0, 0, 0, 0, 0, -(-ci // TILE_K) * TILE_K - ci)).contiguous()


def pack(steps, weights, biases) -> Packed:
    """The C entry's tables of ``steps`` and their weights, packed."""
    rows = [(s.x, s.ci, int(s.up), s.out, s.oc,
             -1 if s.r1 is None else s.r1, -1 if s.r2 is None else s.r2,
             int(s.lrelu)) for s in steps]
    packs = [pack_weight(w.detach()) for w in weights]
    sizes = [p.numel() for p in packs]
    return Packed(
        steps=np.asarray(rows, dtype=np.int32).reshape(-1, 8),
        alphas=np.asarray([(s.a1, s.a2) for s in steps], dtype=np.float32).reshape(-1, 2),
        woff=np.cumsum([0] + sizes[:-1], dtype=np.int64),
        lci=np.asarray([w.shape[1] for w in weights], dtype=np.int32),
        wpack=torch.cat([p.reshape(-1) for p in packs]),
        bias=torch.stack([b.detach() for b in biases]).to(torch.float32).contiguous())


def run(steps, bufs, weights, biases, packed=None):
    """Runs ``steps`` in order on ``bufs`` (contiguous NHWC float32 buffers
    of one batch and device), in place. CPU buffers take the plain version;
    CUDA buffers launch the kernel once per step, all from one call of the C
    entry (building it on first use), or raise. ``packed``: ``pack(steps,
    weights, biases)`` kept by the caller, or None."""
    dev = bufs[0].device
    if dev.type == "cpu":
        return run_plain(steps, bufs, weights, biases)
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    B = bufs[0].shape[0]
    for i, t in enumerate(bufs):
        if t.dtype != torch.float32:
            raise TypeError(f"buffer {i} is {t.dtype}: the kernel takes float32")
        if t.device != dev or t.dim() != 4 or t.shape[0] != B or not t.is_contiguous():
            raise ValueError(f"buffer {i}: want a contiguous [B={B},H,W,C] tensor on "
                             f"{dev}, not {tuple(t.shape)} on {t.device}")
    if len({t.data_ptr() for t in bufs}) != len(bufs):
        raise ValueError("two buffers share their storage")
    if packed is None:
        packed = pack(steps, weights, biases)
    n = len(steps)
    if len(packed.steps) != n or packed.wpack.device != dev or packed.bias.device != dev:
        raise ValueError(f"packed tables of {len(packed.steps)} steps on "
                         f"{packed.wpack.device}, want {n} on {dev}")
    fn = kernel_lib.load("conv3_n32_f32", _ENTRIES).conv3_n32_run
    ptrs = (ctypes.c_void_p * len(bufs))(*(t.data_ptr() for t in bufs))
    dims = (ctypes.c_int32 * (3 * len(bufs)))(*(d for t in bufs for d in t.shape[1:]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(packed.steps.ctypes.data, packed.alphas.ctypes.data, n, ptrs, dims,
                 len(bufs), B, packed.wpack.data_ptr(), packed.woff.ctypes.data,
                 packed.lci.ctypes.data, packed.bias.data_ptr(), stream)
    kernel_lib.check_launch("conv3_n32_run", err)
    conv3x3_n32.launches += n


def conv3x3_n32(x, w, b, ci=None, out=None, oc=0, up=False, lrelu=False,
                r1=None, a1=1.0, r2=None, a2=1.0):
    """One conv: x's channels [0, ci) (all by default) -> ``out``'s channels
    [oc, oc + 32) (a new [B,H,W,32] buffer when None), returned. ``up``:
    through a nearest 2x upsample of x. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    B, H, W = x.shape[:3]
    s = 2 if up else 1
    if out is None:
        out = x.new_empty((B, s * H, s * W, CO))
    bufs = []

    def index(t):  # each tensor once in the buffer list
        if t is None:
            return None
        for i, u in enumerate(bufs):
            if u is t:
                return i
        bufs.append(t)
        return len(bufs) - 1

    step = Step(index(x), x.shape[3] if ci is None else ci, index(out), oc, up, lrelu,
                index(r1), a1, index(r2), a2)
    run([step], bufs, [w], [b])
    return out


# Kernel launches since the last reset, one per conv of either entry; a run
# sets it to 0 before the path it wants to account for and reads it after.
conv3x3_n32.launches = 0
