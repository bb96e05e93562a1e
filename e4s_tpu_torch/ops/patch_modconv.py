"""Patch-modulated 3x3 conv: the hand-written CUDA kernel, its wrapper, its
plain PyTorch version and its build.

    out[b,h,w,o] = dmap[b,h,w,o] * sum_{ty,tx,i} w[o,i,ty,tx]
                                   * smap[b,h,w,i] * x[b,h+ty-1,w+tx-1,i]

x, smap: [B,H,W,Ci]; w: [Co,Ci,3,3] (OIHW, equalised-lr scale applied);
dmap: [B,H,W,Co] or None. This is the whole of a region-masked StyleGAN2
layer once the region styles are gathered per pixel (see ``ops/modconv.py``).

Replaces the Pallas TPU kernel ``e4s_tpu/ops/pallas/modconv_tpu.py``
(``_kernel``, launched by ``_run`` from ``patch_mod_conv3_nhwc``).

On an H100 the large layers are bound by f32 FMA throughput and the small
ones (4^2..16^2) by the single read of the 512x512x9 weight. The kernel in
``csrc/patch_mod_conv3.cu`` is a shared-memory implicit GEMM that forms the
modulated operand in registers, so none of the nine shifted, modulated
copies of x is written to memory; its source note gives the tiling.

The kernel is built at first use with ``nvcc`` into a shared library with a
plain C interface (loaded with ``ctypes``) under ``e4s_tpu_torch/build/``.
"""

from __future__ import annotations

import ctypes
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
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
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


def _launch(x, w, smap, dmap):
    B, H, W, Ci = x.shape
    Co = w.shape[0]
    dev = x.device
    _check("x", x, (B, H, W, Ci), dev)
    _check("smap", smap, (B, H, W, Ci), dev)
    if dmap is not None:
        _check("dmap", dmap, (B, H, W, Co), dev)
    if tuple(w.shape) != (Co, Ci, 3, 3):
        raise ValueError(f"w has shape {tuple(w.shape)}, want {(Co, Ci, 3, 3)}")
    w9 = w.permute(2, 3, 1, 0).contiguous()  # [3,3,Ci,Co], Co minor
    _check("w", w9, (3, 3, Ci, Co), dev)
    lib = _load()
    out = torch.empty((B, H, W, Co), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.patch_mod_conv3_f32(
            x.data_ptr(), w9.data_ptr(), smap.data_ptr(),
            None if dmap is None else dmap.data_ptr(), out.data_ptr(),
            B, H, W, Ci, Co, stream,
        )
    if err != 0:
        raise RuntimeError(f"patch_mod_conv3_f32 launch failed: cudaError {err}")
    patch_mod_conv3_nhwc.launches += 1
    return out


class _PatchModConv3(torch.autograd.Function):
    """Kernel forward; the backward differentiates the plain version, as the
    JAX package routes the Pallas kernel's gradient through XLA
    (``e4s_tpu/ops/modconv.py::_pmc_bwd``). There is no backward kernel."""

    @staticmethod
    def forward(ctx, x, w, smap, dmap):
        ctx.save_for_backward(x, w, smap, dmap)
        return _launch(x, w, smap, dmap)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        ins = [
            None if t is None else t.detach().requires_grad_(need)
            for t, need in zip(saved, ctx.needs_input_grad)
        ]
        wanted = [t for t in ins if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = patch_mod_conv3_nhwc_plain(*ins)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(
            next(grads) if t is not None and t.requires_grad else None
            for t in ins
        )


def patch_mod_conv3_nhwc(x, w, smap, dmap):
    """Patch-modulated 3x3 conv. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (building it on first use) or raises."""
    if x.device.type == "cpu":
        return patch_mod_conv3_nhwc_plain(x, w, smap, dmap)
    return _PatchModConv3.apply(x, w, smap, dmap)


# Kernel launches since the last reset; a run sets it to 0 before the path
# it wants to account for and reads it after.
patch_mod_conv3_nhwc.launches = 0
