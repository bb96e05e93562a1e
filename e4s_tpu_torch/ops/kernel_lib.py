"""What every hand-written CUDA kernel of the port shares: the build, name
and loading of its library, the launch checks, the cache of its layout of
the weights, and the kernel forward with a plain backward.

Each ``csrc/<stem>.cu`` is built by ``nvcc`` into a library of its own with
a plain C interface (every entry returns a ``cudaError``), loaded with
``ctypes``. The directory is the registry: this module names no kernel, and
a new one needs only its source and its wrapper, which declares the entries
it calls (``load``)."""

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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the C entries' argument types: a pointer (data, a stream, a table), an int
PTR, INT = ctypes.c_void_p, ctypes.c_int

_libs = {}  # stem -> the loaded library
_lib_lock = threading.Lock()


def sources() -> dict[str, Path]:
    """Every library's source, by its stem."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(stem: str) -> Path:
    """Build output of ``csrc/<stem>.cu``, named by a digest of that source
    and the flags, so an edited source never loads a stale library and
    rebuilds no other. No source includes another: a header they shared
    would have to join the digest."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{stem}.cu").read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build() -> tuple[list[Path], str]:
    """Compile every library that is missing, one ``nvcc`` per source, all
    started together. Returns the library paths and the compilers'
    ``-Xptxas -v`` reports (registers, shared memory, spills, wgmma
    serialisation); each report is kept beside its library. Raises with the
    reports of the sources that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem, src in sources().items():
        out = library_path(stem)
        if out.exists() and out.with_suffix(".log").exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[stem] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for stem, (cmd, tmp, proc) in jobs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{report}")
            continue
        out = library_path(stem)
        out.with_suffix(".log").write_text(report)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    paths = [library_path(stem) for stem in sources()]
    return paths, "".join(p.with_suffix(".log").read_text() for p in paths)


def load(stem: str, entries: dict) -> ctypes.CDLL:
    """The library of ``csrc/<stem>.cu``, each C entry of ``entries`` (name
    -> argument types) declared. Its first load builds every missing
    library (``build``): a fresh checkout compiles them in one step."""
    lib = _libs.get(stem)
    if lib is None:
        with _lib_lock:
            if stem not in _libs:
                build()
                _libs[stem] = ctypes.CDLL(str(library_path(stem)))
            lib = _libs[stem]
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(name, t, shape, device, dtype):
    """Raises unless the input ``t`` is contiguous, of ``shape``, ``device``, ``dtype``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, x {dtype}: the kernel takes "
                        "one dtype and casts nothing")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_launch(entry: str, err: int):
    """Raises where the C entry ``entry`` returned a nonzero ``cudaError``."""
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


class _Kept:
    """``cached``'s slot on its owner. A copy (``copy.deepcopy``, a pickle)
    starts empty: a copied module carries no kernel layouts."""

    key = value = None

    def __reduce__(self):
        return _Kept, ()


def cached(owner, tensors, build):
    """``build()``, a kernel's layout of ``tensors`` (packed weights), kept
    on ``owner`` and built again when one of them changes in place
    (``load_state_dict``, an optimizer step), moves or changes dtype. Built
    per call where one takes a gradient (it flows through the layout) or is
    not a ``Parameter`` (``torch.func.functional_call`` with, say, a bf16
    cast: a temporary whose storage a later one may reuse)."""
    if not all(isinstance(t, torch.nn.Parameter) for t in tensors) or (
            torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return build()
    key = tuple((t._version, t.data_ptr(), t.device, t.dtype) for t in tensors)
    kept = owner.__dict__.setdefault("_kernel_cache", _Kept())
    if kept.key != key:
        with torch.no_grad():
            kept.value = build()
        kept.key = key
    return kept.value


class PlainGrad(torch.autograd.Function):
    """``launch(*tensors)`` forward; the backward differentiates
    ``plain(*tensors)``, the kernel's plain version, as the JAX package
    routes the Pallas kernel's gradient through XLA
    (``e4s_tpu/ops/modconv.py::_pmc_bwd``). There is no backward kernel."""

    @staticmethod
    def forward(ctx, launch, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    def backward(ctx, g):
        ins = [None if t is None else t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        wanted = [t for t in ins if t is not None and t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(ctx.plain(*ins), wanted, g))
        return None, None, *(next(grads) if t is not None and t.requires_grad
                             else None for t in ins)


def with_plain_grad(launch, plain, tensors, *rest):
    """``launch(*tensors, *rest)``, through ``PlainGrad`` only where a
    gradient of one of ``tensors`` (None for an absent one) is wanted;
    ``rest`` (a packed layout of a weight, flags) takes none."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        return PlainGrad.apply(lambda *t: launch(*t, *rest), plain, *tensors)
    return launch(*tensors, *rest)
