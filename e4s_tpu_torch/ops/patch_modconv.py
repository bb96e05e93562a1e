"""Patch-modulated 3x3 conv: the hand-written CUDA kernel, its wrapper, its
plain PyTorch version and its build.

    out[b,h,w,o] = dmap[b,h,w,o] * sum_{ty,tx,i} w[o,i,ty,tx]
                                   * smap[b,h,w,i] * x[b,h+ty-1,w+tx-1,i]

x, smap: [B,H,W,Ci]; w: [Co,Ci,3,3] (OIHW, equalised-lr scale applied);
dmap: [B,H,W,Co] or None. This is the whole of a region-masked StyleGAN2
layer once the region styles are gathered per pixel (see ``ops/modconv.py``).
The masked up-conv is the same sum in four polyphase forms: phase (a, b)
has its own 3x3 weight ``wp[2a+b]`` and writes output pixel (2h+a, 2w+b),
with smap/dmap read at that pixel of the [B,2H,2W,*] maps
(``patch_mod_conv3_up_nhwc``).

Replaces the Pallas TPU kernel ``e4s_tpu/ops/pallas/modconv_tpu.py``
(``_kernel``, launched by ``_run`` from ``patch_mod_conv3_nhwc``).

On an H100 the large layers are bound by operations and the small ones
(4^2..16^2) by the single read of the 512x512x9 weight. The kernel in
``csrc/patch_mod_conv3.cu`` is an implicit GEMM on the tensor cores in the
3xTF32 split (near-f32 accuracy), fed by TMA bulk copies and cp.async; the
small layers split K over the input channels to fill the card, and an
up-conv is one launch over the four phases. Its source note gives the
tiling.

The kernel takes the weight packed into per-step tiles and split into TF32
halves (``pack_weight``); the model packs each weight once and keeps it
(``models/stylegan2.py::ModulatedConv2d``). It is built at first use with
``nvcc`` into a shared library with a plain C interface (loaded with
``ctypes``) under ``e4s_tpu_torch/build/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "patch_mod_conv3.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
TILE_N, TILE_K = 128, 8  # output channels and input channels of a K step

_lib = None
_lib_lock = threading.Lock()


def patch_mod_conv3_nhwc_plain(x, w, smap, dmap):
    """The nine-tap einsum, as the JAX package's XLA path computes it
    (``e4s_tpu/ops/modconv.py::_patch_mod_conv_nhwc_xla``)."""
    B, H, W, Ci = x.shape
    Co, _, kh, kw = w.shape
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    acc = torch.zeros((B, H, W, Co), dtype=acc_dtype, device=x.device)
    for ty in range(kh):
        for tx in range(kw):
            xs = xp[:, ty:ty + H, tx:tx + W, :]
            acc = acc + torch.matmul(
                (smap * xs).to(acc_dtype), w[:, :, ty, tx].t().to(acc_dtype)
            )
    if dmap is not None:
        acc = acc * dmap
    return acc.to(x.dtype)


def patch_mod_conv3_up_nhwc_plain(x, wp, smap, dmap):
    """The masked up-conv as four stride-1 plain calls, one per polyphase
    weight ``wp[2a+b]`` [Co,Ci,3,3], interleaved to [B,2H,2W,Co]. smap
    [B,2H,2W,Ci] and dmap [B,2H,2W,Co] (or None) are read at each phase's
    output pixels."""
    B, H, W, _ = x.shape
    rows = []
    for a in (0, 1):
        row = []
        for b in (0, 1):
            dm = None if dmap is None else dmap[:, a::2, b::2]
            row.append(patch_mod_conv3_nhwc_plain(
                x, wp[2 * a + b], smap[:, a::2, b::2], dm))
        rows.append(torch.stack(row, dim=3))  # [B,H,W,b,Co]
    return torch.stack(rows, dim=2).reshape(B, 2 * H, 2 * W, wp.shape[1])


def _round_tf32(t):
    """f32 -> the nearest TF32 value (ties away from zero), as the card's
    ``cvt.rna.tf32.f32`` rounds: the low 13 mantissa bits become 0."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def packed_shape(P, Co, Ci):
    """Shape of ``pack_weight``'s result for P phases."""
    return (P, -(-Ci // TILE_K), -(-Co // TILE_N), 2, 9, TILE_N // 8, 2, 8, 4)


def pack_weight(w):
    """OIHW [Co,Ci,3,3] (stride-1) or [4,Co,Ci,3,3] (up phases) -> the
    kernel's tiles: [P, K step (8 input channels), 128-channel block,
    TF32 half, tap, n // 8, k // 4, n % 8, k % 4], zero-padded to whole
    tiles. A block's K step is one contiguous tile in the K-major
    core-matrix layout that wgmma reads (8 rows x 16 bytes per core
    matrix). The halves are the 3xTF32 split of the weight, made once here
    instead of in every block: hi = tf32(w), lo = tf32(w - hi)."""
    wp = w if w.dim() == 5 else w[None]
    P, Co, Ci = wp.shape[:3]
    _, nk, nco = packed_shape(P, Co, Ci)[:3]
    w9 = wp.permute(0, 3, 4, 1, 2).reshape(P, 9, Co, Ci)
    w9 = F.pad(w9, (0, nk * TILE_K - Ci, 0, nco * TILE_N - Co))
    t = w9.reshape(P, 9, nco, TILE_N // 8, 8, nk, 2, 4).permute(
        0, 5, 2, 1, 3, 6, 4, 7).float()
    hi = _round_tf32(t)
    return torch.stack([hi, _round_tf32(t - hi)], dim=3)


def plan(B, H, W, Ci, Co, phases, sms=132):
    """(tile rows, tile columns, K splits) for one launch. 16x16-pixel tiles
    from 64^2 up (each weight tile feeds 256 pixels), 8x16 where W >= 16,
    8x8 below; splits double while the grid stays within one wave of
    ``sms`` blocks (one block fits an SM) and each split keeps >= 4 K
    steps of 8 channels (>= 2 at the last doubling)."""
    th, tw = (16, 16) if H * W >= 64 * 64 else (8, 16) if W >= 16 else (8, 8)
    blocks = (B * phases * -(-H // th) * -(-W // tw)
              * -(-Co // TILE_N))
    steps = -(-Ci // TILE_K)
    splits = 1
    while blocks * splits * 2 <= sms and steps >= 4 * splits:
        splits *= 2
    return th, tw, splits


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """Build output named by a digest of the source and the flags, so an
    edited source never loads a stale library."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpatch_mod_conv3_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernel if its library is missing. Returns the library
    path and the compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills); the report is kept beside the library."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        return out, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )
    report = res.stdout + res.stderr
    log.write_text(report)
    os.replace(tmp, out)
    return out, report


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            fn = lib.patch_mod_conv3_f32
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(x, w, smap, dmap, packed=None, up=False):
    """One kernel launch (plus the split-K sum where the plan splits).
    ``w``: [Co,Ci,3,3], or [4,Co,Ci,3,3] phase weights for ``up``;
    ``packed``: ``pack_weight(w)``, packed here when None."""
    B, H, W, Ci = x.shape
    P, s = (4, 2) if up else (1, 1)
    Co = w.shape[-4]
    dev = x.device
    _check("x", x, (B, H, W, Ci), dev)
    _check("smap", smap, (B, s * H, s * W, Ci), dev)
    if dmap is not None:
        _check("dmap", dmap, (B, s * H, s * W, Co), dev)
    want_w = (4, Co, Ci, 3, 3) if up else (Co, Ci, 3, 3)
    if tuple(w.shape) != want_w:
        raise ValueError(f"w has shape {tuple(w.shape)}, want {want_w}")
    if packed is None:
        packed = pack_weight(w)
    _check("packed weight", packed, packed_shape(P, Co, Ci), dev)
    if Ci % 4:
        raise ValueError(f"Ci={Ci}: the kernel takes a multiple of 4")
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on a CUDA device, not {dev}")
    lib = _load()
    th, tw, splits = plan(B, H, W, Ci, Co, P, _sm_count(dev.index))
    out = torch.empty((B, s * H, s * W, Co), dtype=torch.float32, device=dev)
    part = None
    if splits > 1:
        part = torch.empty((splits, *out.shape), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.patch_mod_conv3_f32(
            x.data_ptr(), packed.data_ptr(), smap.data_ptr(),
            None if dmap is None else dmap.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            B, H, W, Ci, Co, int(up), th, tw, splits, stream,
        )
    if err != 0:
        raise RuntimeError(f"patch_mod_conv3_f32 launch failed: cudaError {err}")
    patch_mod_conv3_nhwc.launches += 1
    return out


class _PatchModConv3(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain version, as the
    JAX package routes the Pallas kernel's gradient through XLA
    (``e4s_tpu/ops/modconv.py::_pmc_bwd``). There is no backward kernel.
    ``packed`` (a layout of ``w``) and ``up`` take no gradient."""

    @staticmethod
    def forward(ctx, x, w, smap, dmap, packed=None, up=False):
        ctx.save_for_backward(x, w, smap, dmap)
        ctx.up = up
        return _launch(x, w, smap, dmap, packed, up)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        ins = [
            None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(saved, ctx.needs_input_grad)
        ]
        wanted = [t for t in ins if t is not None and t.requires_grad]
        plain = (patch_mod_conv3_up_nhwc_plain if ctx.up
                 else patch_mod_conv3_nhwc_plain)
        with torch.enable_grad():
            out = plain(*ins)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(
            next(grads) if t is not None and t.requires_grad else None
            for t in ins
        ) + (None, None)


def patch_mod_conv3_nhwc(x, w, smap, dmap, packed=None):
    """Patch-modulated 3x3 conv. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (building it on first use) or raises.
    ``packed``: ``pack_weight(w)`` kept by the caller, or None."""
    if x.device.type == "cpu":
        return patch_mod_conv3_nhwc_plain(x, w, smap, dmap)
    return _PatchModConv3.apply(x, w, smap, dmap, packed, False)


def patch_mod_conv3_up_nhwc(x, wp, smap, dmap, packed=None):
    """The masked up-conv: x [B,H,W,Ci], phase weights wp [4,Co,Ci,3,3],
    smap [B,2H,2W,Ci], dmap [B,2H,2W,Co] or None -> [B,2H,2W,Co]. One
    kernel launch on a CUDA tensor; the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return patch_mod_conv3_up_nhwc_plain(x, wp, smap, dmap)
    return _PatchModConv3.apply(x, wp, smap, dmap, packed, True)


# Kernel launches since the last reset, one per call of either entry; a run
# sets it to 0 before the path it wants to account for and reads it after.
patch_mod_conv3_nhwc.launches = 0
