"""Smoke run of the PyTorch/CUDA port (``e4s_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

  1. card: device name and count, ``nvidia-smi`` name and power limit;
  2. build: compile every CUDA kernel of the main path from ``csrc/`` and
     print the ``-Xptxas -v`` report;
  3. kernel vs plain: each kernel against its plain PyTorch version at every
     shape the main path gives it;
  4. main path: ``FaceSwapper`` at 1024^2 (K=13, 18 styles, seeded random
     weights) answers 3 swap requests on the example pair; counts the kernel
     launches of each request;
  5. whole path, kernel vs plain: the same seeded swapper at 256^2 on the
     card and on the CPU (plain kernel versions), compared as PSNR;
  6. kernel times with CUDA events against the roofline bound.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the per-kernel JSON summary. TF32 is off throughout.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Main-path shapes of the patch-modulated conv at B=1: (input H=W, Ci, Co,
# launches per swap). Stride-1 convs run at their resolution, each masked
# up-conv runs 4 polyphase launches at its input resolution.
PMC_STAGES = [
    ("4^2 stride-1", 4, 512, 512, 1),
    ("4->8 up", 4, 512, 512, 4),
    ("8^2 stride-1", 8, 512, 512, 1),
    ("8->16 up", 8, 512, 512, 4),
    ("16^2 stride-1", 16, 512, 512, 1),
    ("16->32 up", 16, 512, 512, 4),
    ("32^2 stride-1", 32, 512, 512, 1),
    ("32->64 up", 32, 512, 512, 4),
    ("64^2 stride-1", 64, 512, 512, 1),
    ("64->128 up", 64, 512, 256, 4),
    ("128^2 stride-1", 128, 256, 256, 1),
    ("128->256 up", 128, 256, 128, 4),
    ("256^2 stride-1", 256, 128, 128, 1),
]
PMC_LAUNCHES_PER_SWAP = sum(s[4] for s in PMC_STAGES)  # 31


def log(msg=""):
    print(msg, flush=True)


def phase_card():
    if not torch.cuda.is_available():
        log("FAIL card: torch.cuda.is_available() is false")
        sys.exit(1)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {name} x{count}")
    log(f"[card] nvidia-smi: {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return name, count, smi


def phase_build():
    from e4s_tpu_torch.ops import patch_modconv as pmc

    t0 = time.perf_counter()
    path, report = pmc.build()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in report.strip().splitlines():
        log(f"[build] {line}")


def _pmc_inputs(H, Ci, Co, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    x = torch.randn((1, H, H, Ci), generator=g, device=dev)
    w = torch.randn((Co, Ci, 3, 3), generator=g, device=dev) / math.sqrt(Ci * 9)
    smap = 1.0 + 0.5 * torch.randn((1, H, H, Ci), generator=g, device=dev)
    dmap = 0.5 + torch.rand((1, H, H, Co), generator=g, device=dev)
    return x, w, smap, dmap


def pmc_cost(H, Ci, Co):
    """FLOPs and bytes of one launch: x, smap, dmap, out and W once, f32."""
    flops = 2.0 * H * H * Co * Ci * 9
    nbytes = 4.0 * (2 * H * H * Ci + 2 * H * H * Co + 9 * Ci * Co)
    return flops, nbytes


def phase_kernel_vs_plain():
    from e4s_tpu_torch.ops.patch_modconv import (
        patch_mod_conv3_nhwc,
        patch_mod_conv3_nhwc_plain,
    )

    worst = 0.0
    for i, (label, H, Ci, Co, _) in enumerate(PMC_STAGES):
        x, w, smap, dmap = _pmc_inputs(H, Ci, Co, seed=i)
        got = patch_mod_conv3_nhwc(x, w, smap, dmap)
        torch.cuda.synchronize()
        want = patch_mod_conv3_nhwc_plain(x, w, smap, dmap)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = err <= 1e-4 * scale and torch.isfinite(got).all().item()
        log(f"[kernel] patch_mod_conv3 {label:15s} H={H:3d} {Ci:3d}->{Co:3d} "
            f"max|diff|={err:.3e} max|plain|={scale:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"FAIL kernel: patch_mod_conv3 at {label}")
        worst = max(worst, err)
    return worst


def _time_cuda(fn, iters=20, flush=None):
    """Mean ms per call from CUDA events around each call. Calls are queued
    back to back (one synchronise at the end), each behind an overwrite of
    a buffer larger than the 50 MB L2, so the card never waits on the host
    and every call starts with a cold cache, as on the path."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def phase_kernel_times():
    from e4s_tpu_torch.ops.patch_modconv import (
        patch_mod_conv3_nhwc,
        patch_mod_conv3_nhwc_plain,
    )

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = []
    for i, (label, H, Ci, Co, n) in enumerate(PMC_STAGES):
        x, w, smap, dmap = _pmc_inputs(H, Ci, Co, seed=i)
        ms = _time_cuda(lambda: patch_mod_conv3_nhwc(x, w, smap, dmap), flush=flush)
        plain = _time_cuda(
            lambda: patch_mod_conv3_nhwc_plain(x, w, smap, dmap), flush=flush
        )
        # context only: a plain conv of the same shape is a different function
        xc = x.permute(0, 3, 1, 2)
        conv = _time_cuda(
            lambda: torch.nn.functional.conv2d(xc, w, padding=1), flush=flush
        )
        flops, nbytes = pmc_cost(H, Ci, Co)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        rows.append(dict(stage=label, launches=n, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes))
        log(f"[time] patch_mod_conv3 {label:15s} x{n} kernel {ms:.4f} ms  "
            f"plain {plain:.4f} ms  bound {bound:.4f} ms ({by})  "
            f"share {bound / ms:.3f}  [F.conv2d f32 same shape, other "
            f"function: {conv:.4f} ms]")
    return rows


def _opts(out_size, n_styles):
    import types

    return types.SimpleNamespace(
        num_seg_cls=12, out_size=out_size, remaining_layer_idx=13,
        n_styles=n_styles, start_from_latent_avg=True, checkpoint_path=None,
        faceParsing_ckpt=None,
    )


EXAMPLE = os.path.join("example", "input", "faceswap")


def phase_main_path():
    """FaceSwapper at 1024^2 answers 3 requests; returns launches per swap."""
    from e4s_tpu_torch.ops.patch_modconv import patch_mod_conv3_nhwc
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    t0 = time.perf_counter()
    swapper = FaceSwapper(_opts(1024, 18), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[main] FaceSwapper 1024^2 K=13 n_styles=18 built in "
        f"{time.perf_counter() - t0:.1f} s")
    finite = []
    swapper.net.G.register_forward_hook(
        lambda m, i, out: finite.append(torch.isfinite(out[0]).all())
    )
    src = os.path.join(EXAMPLE, "source.jpg")
    tgt = os.path.join(EXAMPLE, "target.jpg")
    torch.cuda.reset_peak_memory_stats()
    launches, times = [], []
    for r in range(3):
        torch.cuda.synchronize()
        patch_mod_conv3_nhwc.launches = 0
        t0 = time.perf_counter()
        img = swapper.swap(src, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(patch_mod_conv3_nhwc.launches)
        arr = np.asarray(img)
        if arr.shape != (1024, 1024, 3) or arr.dtype != np.uint8:
            raise SystemExit(f"FAIL main: result {arr.shape} {arr.dtype}")
        if not finite[-1].item():
            raise SystemExit("FAIL main: non-finite face before the uint8 cast")
        log(f"[main] request {r}{' (warm-up)' if r == 0 else ''}: "
            f"{times[-1]:.1f} ms, patch_mod_conv3 launches {launches[-1]}, "
            f"mean pixel {arr.mean():.2f}")
        if launches[-1] != PMC_LAUNCHES_PER_SWAP:
            raise SystemExit(f"FAIL main: {launches[-1]} kernel launches, "
                             f"want {PMC_LAUNCHES_PER_SWAP}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] ms per 1024^2 swap (requests 1-2): "
        f"{', '.join(f'{t:.1f}' for t in times[1:])}; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    del swapper
    torch.cuda.empty_cache()
    return launches[-1]


def phase_whole_path_vs_plain():
    """The same seeded swapper at 256^2 on the card and on the CPU (where
    every kernel wrapper takes its plain version): uint8 PSNR >= 40 dB."""
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        swapper = FaceSwapper(_opts(256, 14), device=dev, seed=1)
        img = swapper.swap(os.path.join(EXAMPLE, "source.jpg"),
                           os.path.join(EXAMPLE, "target.jpg"))
        out[dev] = np.asarray(img).astype(np.float64)
        log(f"[whole] 256^2 swap on {dev}: {time.perf_counter() - t0:.1f} s "
            f"(build included)")
        del swapper
    mse = np.mean((out["cuda"] - out["cpu"]) ** 2)
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    log(f"[whole] cuda vs cpu uint8 PSNR {psnr:.2f} dB, max |diff| "
        f"{np.abs(out['cuda'] - out['cpu']).max():.0f}")
    if psnr < 40.0:
        raise SystemExit(f"FAIL whole: PSNR {psnr:.2f} dB < 40")


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, _ = phase_card()
    phase_build()
    worst = phase_kernel_vs_plain()
    launches = phase_main_path()
    phase_whole_path_vs_plain()
    rows = phase_kernel_times()

    def per_swap(key):
        return sum(r[key] * r["launches"] for r in rows)

    t_ops = sum(r["flops"] * r["launches"] for r in rows) / PEAK_F32_FLOPS * 1e3
    t_bytes = sum(r["bytes"] * r["launches"] for r in rows) / PEAK_BYTES * 1e3
    log(f"[time] patch_mod_conv3 per swap ({launches} launches): kernel "
        f"{per_swap('ms'):.4f} ms, plain {per_swap('plain_ms'):.4f} ms, bound "
        f"{per_swap('bound_ms'):.4f} ms (sum of per-launch bounds)")
    summary = {"kernels": [{
        "name": "patch_mod_conv3",
        "route": "cuda",
        "source": "e4s_tpu_torch/csrc/patch_mod_conv3.cu",
        "replaces": "e4s_tpu/ops/pallas/modconv_tpu.py:39",
        "launches": launches,
        "max_abs_err": worst,
        "ms": per_swap("ms"),
        "plain_ms": per_swap("plain_ms"),
        "bound_ms": per_swap("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}
    log(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
