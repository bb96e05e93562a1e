"""Smoke run of the PyTorch/CUDA port (``e4s_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

  1. card: device name and count, ``nvidia-smi`` name and power limit;
  2. build: compile every CUDA kernel of the main path from ``csrc/`` and
     print the ``-Xptxas -v`` report;
  3. kernel vs plain: each kernel entry (stride-1 and fused masked up-conv)
     against its plain PyTorch version at every shape the main path gives
     it (and, as context, both against the plain version in f64);
  4. main path: ``FaceSwapper`` at 1024^2 (K=13, 18 styles, seeded random
     weights) answers 3 swap requests on the example pair; counts the kernel
     launches of each request (13: 7 stride-1 + 6 up);
  5. whole path, kernel vs plain: the same seeded swapper at 256^2 on the
     card and on the CPU (plain kernel versions), compared as PSNR;
  6. kernel times with CUDA events against two bounds: f32 outside the
     tensor cores, and 3xTF32 on them (three TF32 passes, the kernel's
     arithmetic). The weights are packed before the timed window, as the
     model keeps them packed;
  7. the SegNeXt-small parser with the Laplacian blend (``lap_bld``): the
     same 1024^2 model answers 3 fused requests, then one request with the
     example's target mask (the staged path); 13 launches each;
  8. ``swap_batch``: 8 distinct uint8 pairs (flips and shifts of the
     example pair) in one chunk of 8 (13 launches) and in chunks of 1
     (13 per chunk): swaps/s and peak memory; then the kernel against its
     plain version at batch 8 at all 13 stages, with times and bounds;
  9. the new paths at 256^2 on the card and on the CPU: the SegNeXt +
     ``lap_bld`` fused swap and the staged target-mask path, as PSNR.

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

# H100 SXM published peaks: f32 outside the tensor cores, dense TF32 on
# them, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

# Main-path launches of the patch-modulated conv at B=1, one each per swap:
# (label, input H=W, Ci, Co, up). A stride-1 conv runs at its resolution; a
# masked up-conv is one launch over its 4 polyphase convs at the input
# resolution, writing the 2x output.
PMC_STAGES = [
    ("4^2 stride-1", 4, 512, 512, False),
    ("4->8 up", 4, 512, 512, True),
    ("8^2 stride-1", 8, 512, 512, False),
    ("8->16 up", 8, 512, 512, True),
    ("16^2 stride-1", 16, 512, 512, False),
    ("16->32 up", 16, 512, 512, True),
    ("32^2 stride-1", 32, 512, 512, False),
    ("32->64 up", 32, 512, 512, True),
    ("64^2 stride-1", 64, 512, 512, False),
    ("64->128 up", 64, 512, 256, True),
    ("128^2 stride-1", 128, 256, 256, False),
    ("128->256 up", 128, 256, 128, True),
    ("256^2 stride-1", 256, 128, 128, False),
]
PMC_LAUNCHES_PER_SWAP = len(PMC_STAGES)  # 13


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


def _pmc_inputs(H, Ci, Co, up, seed, B=1):
    """x [B,H,H,Ci]; w [Co,Ci,3,3] (or 4 phase weights for ``up``); smap,
    dmap at the output resolution."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    s = 2 if up else 1
    x = torch.randn((B, H, H, Ci), generator=g, device=dev)
    w = torch.randn(((4,) if up else ()) + (Co, Ci, 3, 3), generator=g,
                    device=dev) / math.sqrt(Ci * 9)
    smap = 1.0 + 0.5 * torch.randn((B, s * H, s * H, Ci), generator=g, device=dev)
    dmap = 0.5 + torch.rand((B, s * H, s * H, Co), generator=g, device=dev)
    return x, w, smap, dmap


def _pmc_entries(up):
    from e4s_tpu_torch.ops import patch_modconv as pmc

    if up:
        return pmc.patch_mod_conv3_up_nhwc, pmc.patch_mod_conv3_up_nhwc_plain
    return pmc.patch_mod_conv3_nhwc, pmc.patch_mod_conv3_nhwc_plain


def pmc_cost(H, Ci, Co, up, B=1):
    """FLOPs and bytes of one launch at batch B, f32: x, smap, dmap, out
    and every phase weight once (an up launch: 4 phases, maps and output at
    2H)."""
    P, s = (4, 2) if up else (1, 1)
    flops = 2.0 * B * H * H * Co * Ci * 9 * P
    nbytes = 4.0 * (B * (H * H * Ci + s * s * H * H * (Ci + 2 * Co))
                    + P * 9 * Ci * Co)
    return flops, nbytes


def pmc_bounds(H, Ci, Co, up, B=1):
    """(f32 SIMT bound ms, 3xTF32 tensor-core bound ms, what bounds the
    latter): the larger of FLOPs over the peak and bytes over HBM."""
    flops, nbytes = pmc_cost(H, Ci, Co, up, B)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    f32 = max(flops / PEAK_F32_FLOPS * 1e3, t_bytes)
    t_tc = 3 * flops / PEAK_TF32_FLOPS * 1e3
    return f32, max(t_tc, t_bytes), "operations" if t_tc >= t_bytes else "bytes"


def phase_kernel_vs_plain(B=1):
    worst = 0.0
    for i, (label, H, Ci, Co, up) in enumerate(PMC_STAGES):
        kernel, plain = _pmc_entries(up)
        x, w, smap, dmap = _pmc_inputs(H, Ci, Co, up, seed=i, B=B)
        got = kernel(x, w, smap, dmap)
        torch.cuda.synchronize()
        want = plain(x, w, smap, dmap)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = err <= 1e-4 * scale and torch.isfinite(got).all().item()
        # context: both against the plain version in f64
        ref = plain(*(t.double() for t in (x, w, smap, dmap)))
        e_k = (got.double() - ref).abs().max().item()
        e_p = (want.double() - ref).abs().max().item()
        log(f"[kernel] B={B} {kernel.__name__} {label:15s} H={H:3d} {Ci:3d}->{Co:3d} "
            f"max|diff|={err:.3e} max|plain|={scale:.3e} "
            f"{'ok' if ok else 'FAIL'}  [vs f64: kernel {e_k:.3e}, "
            f"plain f32 {e_p:.3e}]")
        if not ok:
            raise SystemExit(f"FAIL kernel: patch_mod_conv3 at {label}, B={B}")
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


def phase_kernel_times(B=1):
    from e4s_tpu_torch.ops.patch_modconv import pack_weight, plan

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = []
    log(f"[time] B={B}: weights packed before the timed window (the model "
        "keeps them packed); plain takes the OIHW weights")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (label, H, Ci, Co, up) in enumerate(PMC_STAGES):
        kernel, plain = _pmc_entries(up)
        x, w, smap, dmap = _pmc_inputs(H, Ci, Co, up, seed=i, B=B)
        packed = pack_weight(w)
        th, tw, splits = plan(B, H, H, Ci, Co, 4 if up else 1, sms)
        ms = _time_cuda(lambda: kernel(x, w, smap, dmap, packed), flush=flush)
        plain_ms = _time_cuda(lambda: plain(x, w, smap, dmap), flush=flush)
        # context only: a plain conv of one phase's shape, a different function
        xc = x.permute(0, 3, 1, 2)
        wc = w[0] if up else w
        conv = _time_cuda(
            lambda: torch.nn.functional.conv2d(xc, wc, padding=1), flush=flush
        )
        flops, nbytes = pmc_cost(H, Ci, Co, up, B)
        f32, tc, by = pmc_bounds(H, Ci, Co, up, B)
        rows.append(dict(stage=label, ms=ms, plain_ms=plain_ms, f32_ms=f32,
                         bound_ms=tc, bound_by=by, flops=flops, bytes=nbytes))
        log(f"[time] B={B} patch_mod_conv3 {label:15s} tile {th}x{tw} splits "
            f"{splits:2d}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  f32 bound {f32:.4f} ms (share {f32 / ms:.3f})  "
            f"3xTF32 bound {tc:.4f} ms ({by}, share {tc / ms:.3f})  "
            f"[F.conv2d f32 one phase's shape, other function: {conv:.4f} ms]")
    return rows


def _opts(out_size, n_styles, **kw):
    import types

    return types.SimpleNamespace(
        num_seg_cls=12, out_size=out_size, remaining_layer_idx=13,
        n_styles=n_styles, start_from_latent_avg=True, checkpoint_path=None,
        faceParsing_ckpt=None, **kw,
    )


SEGNEXT_LAP = dict(faceParser_name="segnext", segnext_variant="small",
                   lap_bld=True)


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


def _example_target_mask():
    """The example's CelebAMask-HQ target mask (512^2) as the detailed 12
    classes, as the CLI reads ``--target_mask``."""
    from PIL import Image

    from e4s_tpu_torch.utils.label_maps import (
        celebahq_mask_to_faceparser_mask_detailed,
    )

    img = Image.open(os.path.join(EXAMPLE, "target_mask.png")).convert("L")
    return celebahq_mask_to_faceparser_mask_detailed(np.asarray(img))


def _finite_hook(swapper):
    """Records, per synthesis call, whether the face is finite before the
    uint8 cast."""
    finite = []
    swapper.net.G.register_forward_hook(
        lambda m, i, out: finite.append(torch.isfinite(out[0]).all()))
    return finite


def _requests(swapper, label, n, finite, **kw):
    """``n`` swap requests of the example pair; each must make 13 kernel
    launches and give a finite 1024^2 face. Returns the request times."""
    from e4s_tpu_torch.ops.patch_modconv import patch_mod_conv3_nhwc

    src = os.path.join(EXAMPLE, "source.jpg")
    tgt = os.path.join(EXAMPLE, "target.jpg")
    times = []
    for r in range(n):
        torch.cuda.synchronize()
        patch_mod_conv3_nhwc.launches = 0
        t0 = time.perf_counter()
        img = swapper.swap(src, tgt, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = patch_mod_conv3_nhwc.launches
        arr = np.asarray(img)
        log(f"[{label}] request {r}{' (warm-up)' if r == 0 else ''}: "
            f"{times[-1]:.1f} ms, patch_mod_conv3 launches {launches}, "
            f"mean pixel {arr.mean():.2f}")
        if arr.shape != (1024, 1024, 3) or arr.dtype != np.uint8:
            raise SystemExit(f"FAIL {label}: result {arr.shape} {arr.dtype}")
        if not finite[-1].item():
            raise SystemExit(f"FAIL {label}: non-finite face before the uint8 cast")
        if launches != PMC_LAUNCHES_PER_SWAP:
            raise SystemExit(f"FAIL {label}: {launches} kernel launches, "
                             f"want {PMC_LAUNCHES_PER_SWAP}")
    return times


def phase_segnext_lap():
    """SegNeXt-small + lap_bld at 1024^2: 3 fused requests, then 2 with the
    example's target mask (the staged path)."""
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    t0 = time.perf_counter()
    swapper = FaceSwapper(_opts(1024, 18, **SEGNEXT_LAP), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[segnext] FaceSwapper 1024^2 SegNeXt-small + lap_bld built in "
        f"{time.perf_counter() - t0:.1f} s")
    finite = _finite_hook(swapper)
    torch.cuda.reset_peak_memory_stats()
    fused = _requests(swapper, "segnext", 3, finite)
    staged = _requests(swapper, "staged", 2, finite,
                       target_mask=_example_target_mask())
    log(f"[segnext] ms per 1024^2 request: SegNeXt + lap_bld fused "
        f"{', '.join(f'{t:.1f}' for t in fused[1:])}; staged target-mask "
        f"{staged[1]:.1f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del swapper
    torch.cuda.empty_cache()


def _batch_pairs(n=8, S=1024):
    """``n`` distinct uint8 pairs [n,3,S,S]: the example pair mirrored
    (odd i) and shifted by 24 px steps (source across, target down)."""
    from PIL import Image

    def load(name):
        img = Image.open(os.path.join(EXAMPLE, name)).convert("RGB").resize((S, S))
        return np.transpose(np.asarray(img), (2, 0, 1))

    s0, t0 = load("source.jpg"), load("target.jpg")
    src, tgt = [], []
    for i in range(n):
        shift = (i // 2) * 24
        src.append(np.roll(s0[:, :, ::-1] if i % 2 else s0, shift, axis=2))
        tgt.append(np.roll(t0[:, :, ::-1] if i % 2 else t0, shift, axis=1))
    return np.ascontiguousarray(np.stack(src)), np.ascontiguousarray(np.stack(tgt))


def phase_swap_batch():
    """swap_batch of 8 distinct uint8 pairs at 1024^2 in one chunk of 8 and
    in chunks of 1 (each warmed up once, then timed twice); 13 launches per
    chunk. Returns swaps/s per chunk size."""
    from e4s_tpu_torch.ops.patch_modconv import patch_mod_conv3_nhwc
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    swapper = FaceSwapper(_opts(1024, 18), device="cuda", seed=0)
    finite = _finite_hook(swapper)
    src, tgt = _batch_pairs()
    rates = {}
    for chunk in (8, 1):
        swapper.swap_batch(src, tgt, chunk=chunk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(2):
            finite.clear()
            patch_mod_conv3_nhwc.launches = 0
            t0 = time.perf_counter()
            out = swapper.swap_batch(src, tgt, chunk=chunk)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            launches = patch_mod_conv3_nhwc.launches
            want = PMC_LAUNCHES_PER_SWAP * (len(src) // chunk)
            if launches != want:
                raise SystemExit(f"FAIL batch: chunk {chunk}: {launches} "
                                 f"kernel launches, want {want}")
            if out.shape != src.shape or out.dtype != np.uint8:
                raise SystemExit(f"FAIL batch: result {out.shape} {out.dtype}")
            if not all(f.item() for f in finite):
                raise SystemExit("FAIL batch: non-finite face")
        distinct = len({out[i].tobytes() for i in range(len(out))})
        if distinct != len(out):
            raise SystemExit(f"FAIL batch: {distinct} distinct results of {len(out)}")
        rates[chunk] = [len(src) / t for t in runs]
        log(f"[batch] swap_batch 8 pairs 1024^2 uint8, chunk {chunk}: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in runs)} ms "
            f"({', '.join(f'{r:.3f}' for r in rates[chunk])} swaps/s), "
            f"{launches} launches ({launches * chunk // len(src)} per chunk), "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[batch] swaps/s chunk 8 over chunk 1: "
        f"{max(rates[8]) / max(rates[1]):.3f}x (best of two each)")
    del swapper
    torch.cuda.empty_cache()
    return rates


def phase_new_paths_vs_plain():
    """The seeded SegNeXt-small + lap_bld swapper at 256^2 on the card and on
    the CPU (plain kernel versions): the fused swap and the staged
    target-mask path, uint8 PSNR >= 40 dB each."""
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    src = os.path.join(EXAMPLE, "source.jpg")
    tgt = os.path.join(EXAMPLE, "target.jpg")
    mask = _example_target_mask()
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        swapper = FaceSwapper(_opts(256, 14, **SEGNEXT_LAP), device=dev, seed=1)
        out[dev] = [np.asarray(swapper.swap(src, tgt)).astype(np.float64),
                    np.asarray(swapper.swap(src, tgt, target_mask=mask)).astype(np.float64)]
        log(f"[whole] 256^2 SegNeXt + lap_bld fused and staged on {dev}: "
            f"{time.perf_counter() - t0:.1f} s (build included)")
        del swapper
    for i, name in enumerate(("SegNeXt + lap_bld fused", "staged target mask")):
        a, b = out["cuda"][i], out["cpu"][i]
        mse = np.mean((a - b) ** 2)
        psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        log(f"[whole] {name}: cuda vs cpu uint8 PSNR {psnr:.2f} dB, max |diff| "
            f"{np.abs(a - b).max():.0f}")
        if psnr < 40.0:
            raise SystemExit(f"FAIL whole: {name} PSNR {psnr:.2f} dB < 40")


def _per_swap_line(rows, launches, B=1):
    def total(key):
        return sum(r[key] for r in rows)

    log(f"[time] B={B} patch_mod_conv3 per swap pass ({launches} launches): "
        f"kernel {total('ms'):.4f} ms, plain {total('plain_ms'):.4f} ms, "
        f"f32 bound {total('f32_ms'):.4f} ms, 3xTF32 bound "
        f"{total('bound_ms'):.4f} ms (sums of per-launch bounds; share "
        f"{total('bound_ms') / total('ms'):.3f})")
    return total


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, _ = phase_card()
    phase_build()
    worst = phase_kernel_vs_plain()
    launches = phase_main_path()
    phase_whole_path_vs_plain()
    rows = phase_kernel_times()
    per_swap = _per_swap_line(rows, launches)
    t_ops = 3 * sum(r["flops"] for r in rows) / PEAK_TF32_FLOPS * 1e3
    t_bytes = sum(r["bytes"] for r in rows) / PEAK_BYTES * 1e3
    phase_segnext_lap()
    phase_swap_batch()
    worst = max(worst, phase_kernel_vs_plain(B=8))
    _per_swap_line(phase_kernel_times(B=8), PMC_LAUNCHES_PER_SWAP, B=8)
    phase_new_paths_vs_plain()
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
