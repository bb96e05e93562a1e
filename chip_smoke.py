"""Smoke run of the PyTorch/CUDA port (``e4s_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first that fails ends the run with a non-zero exit:

  1. card: device name and count, ``nvidia-smi`` name and power limit;
  2. build: compile every CUDA kernel of the main path from ``csrc/`` (one
     nvcc per source, run together) and print the ``-Xptxas -v`` report;
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
     ``lap_bld`` fused swap and the staged target-mask path, as PSNR;
 10. the bf16 kernel against its bf16 plain version at the 13 stages,
     B = 1 and 8, and its times (cold L2) against the bf16 bound;
 11. ``--bf16`` swaps at 1024^2 (BiSeNet + feather): 3 requests, 13 bf16
     launches each, peak memory; then at 256^2 bf16 on the card against
     bf16 on the CPU, and bf16 against f32 on the card, as PSNR;
 12. the edit sweep at 1024^2: ``Editor.interpolation_sweep`` with 4 alphas
     over two regions on the ``faceedit`` pair, 13 launches for the sweep;
     then at 256^2 the card against the CPU, as PSNR;
 13. inversion at 1024^2: 5 steps of ``Optimizer.invertion`` in f32 and in
     bf16 on a synthetic face, the loss and ms of each step and 13 launches
     per step's forward; then at 256^2 the card's and the CPU's losses over
     3 steps in f32, within 1e-3 relative;
 14. ``swap_batch`` with ``bf16``: the 8 pairs of phase 8 in one chunk of 8
     and in chunks of 1, 13 launches of the bf16 kernel per chunk: swaps/s
     and peak memory;
 15. training at full width: both kernels against their plain versions
     at training's batch 2 at the 13 stages (f32 and bf16); then the
     ``Coach`` (Net3 1024^2, K=13, D 1024,
     batch 2, synthetic faces, Adam, the default loss weights, D every
     step and R1 every 2nd) runs ``train()`` for 5 steps in f32 inside a
     one-process NCCL group (DDP around Net3 and D, as ``torchrun
     --nproc_per_node 1`` would), then in ``bf16``: warm ms per G, D and
     R1 step, peak memory, 13 kernel launches per G and per D step (bf16
     ones under ``bf16``), the two costs of the masked conv's backward
     (building the kernel's weights per call; the plain version's
     backward) and finite losses; then the f32 run's checkpoint loads into
     a 1024^2 swap (13 launches);
 16. training at 64^2 on the card against the CPU: one G step and one D
     step from the same weights, batch and noise: the losses within 1e-4
     of max(|CPU value|, 1), the signs of the updates differing in at most
     1% of the elements.

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

# H100 SXM published peaks: f32 outside the tensor cores, dense TF32 and
# dense BF16 on them, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# max |kernel - plain| allowed, relative to max |plain|: f32 sums of up to
# 9 * 512 terms in another order; bf16 results that may round to the
# neighbouring bf16 value (one ulp is 2^-8 relative)
PMC_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}

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
    paths, report = pmc.build()
    log(f"[build] {', '.join(p.name for p in paths)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, together)")
    for line in report.strip().splitlines():
        log(f"[build] {line}")


def _pmc_inputs(H, Ci, Co, up, seed, B=1, dtype=torch.float32):
    """x [B,H,H,Ci]; w [Co,Ci,3,3] (or 4 phase weights for ``up``); smap,
    dmap at the output resolution; drawn in f32, then cast to ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    s = 2 if up else 1
    x = torch.randn((B, H, H, Ci), generator=g, device=dev)
    w = torch.randn(((4,) if up else ()) + (Co, Ci, 3, 3), generator=g,
                    device=dev) / math.sqrt(Ci * 9)
    smap = 1.0 + 0.5 * torch.randn((B, s * H, s * H, Ci), generator=g, device=dev)
    dmap = 0.5 + torch.rand((B, s * H, s * H, Co), generator=g, device=dev)
    return tuple(t.to(dtype) for t in (x, w, smap, dmap))


def _pmc_entries(up):
    from e4s_tpu_torch.ops import patch_modconv as pmc

    if up:
        return pmc.patch_mod_conv3_up_nhwc, pmc.patch_mod_conv3_up_nhwc_plain
    return pmc.patch_mod_conv3_nhwc, pmc.patch_mod_conv3_nhwc_plain


def pmc_cost(H, Ci, Co, up, B=1, itemsize=4):
    """FLOPs and bytes of one launch at batch B: x, smap, dmap, out and
    every phase weight once, ``itemsize`` bytes each (an up launch: 4
    phases, maps and output at 2H)."""
    P, s = (4, 2) if up else (1, 1)
    flops = 2.0 * B * H * H * Co * Ci * 9 * P
    nbytes = itemsize * (B * (H * H * Ci + s * s * H * H * (Ci + 2 * Co))
                         + P * 9 * Ci * Co)
    return flops, nbytes


def pmc_bounds(H, Ci, Co, up, B=1, dtype=torch.float32):
    """(f32 SIMT bound ms, tensor-core bound ms, what bounds the latter):
    each the larger of FLOPs over the peak and bytes over HBM. f32: the
    3xTF32 split's three TF32 products; bf16: one bf16 product, 2-byte
    activations and weights (its first entry is then the same bound)."""
    if dtype == torch.bfloat16:
        flops, nbytes = pmc_cost(H, Ci, Co, up, B, itemsize=2)
        t_tc = flops / PEAK_BF16_FLOPS * 1e3
    else:
        flops, nbytes = pmc_cost(H, Ci, Co, up, B)
        t_tc = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    tc = max(t_tc, t_bytes)
    f32 = tc if dtype == torch.bfloat16 else max(
        flops / PEAK_F32_FLOPS * 1e3, t_bytes)
    return f32, tc, "operations" if t_tc >= t_bytes else "bytes"


def _dt(dtype):
    return "bf16" if dtype == torch.bfloat16 else "f32"


def phase_kernel_vs_plain(B=1, dtype=torch.float32):
    """Both entries against their plain versions at the 13 stages, in
    ``dtype``; returns the largest max |diff|."""
    worst = 0.0
    tol = PMC_TOL[dtype]
    for i, (label, H, Ci, Co, up) in enumerate(PMC_STAGES):
        kernel, plain = _pmc_entries(up)
        x, w, smap, dmap = _pmc_inputs(H, Ci, Co, up, seed=i, B=B, dtype=dtype)
        got = kernel(x, w, smap, dmap)
        torch.cuda.synchronize()
        want = plain(x, w, smap, dmap)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = err <= tol * scale and torch.isfinite(got).all().item()
        # context: both against the plain version in f64 on the same inputs
        ref = plain(*(t.double() for t in (x, w, smap, dmap)))
        e_k = (got.double() - ref).abs().max().item()
        e_p = (want.double() - ref).abs().max().item()
        log(f"[kernel] {_dt(dtype)} B={B} {kernel.__name__} {label:15s} H={H:3d} "
            f"{Ci:3d}->{Co:3d} max|diff|={err:.3e} max|plain|={scale:.3e} "
            f"(limit {tol:g} of it) {'ok' if ok else 'FAIL'}  [vs f64: kernel "
            f"{e_k:.3e}, plain {_dt(dtype)} {e_p:.3e}]")
        if not ok:
            raise SystemExit(f"FAIL kernel: patch_mod_conv3 {_dt(dtype)} at "
                             f"{label}, B={B}")
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


def phase_kernel_times(B=1, dtype=torch.float32):
    from e4s_tpu_torch.ops.patch_modconv import pack_weight, plan, plan_bf16

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = []
    dt = _dt(dtype)
    log(f"[time] {dt} B={B}: weights packed before the timed window (the "
        "model keeps them packed); plain takes the OIHW weights")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (label, H, Ci, Co, up) in enumerate(PMC_STAGES):
        kernel, plain = _pmc_entries(up)
        x, w, smap, dmap = _pmc_inputs(H, Ci, Co, up, seed=i, B=B, dtype=dtype)
        packed = pack_weight(w)
        if dtype == torch.bfloat16:
            th, tw, splits = plan_bf16(B, H, H, Ci, Co, 4 if up else 1, sms)
        else:
            th, tw, splits = plan(B, H, H, Ci, Co, 4 if up else 1, sms)
        ms = _time_cuda(lambda: kernel(x, w, smap, dmap, packed), flush=flush)
        plain_ms = _time_cuda(lambda: plain(x, w, smap, dmap), flush=flush)
        # context only: a plain conv of one phase's shape, a different function
        xc = x.permute(0, 3, 1, 2)
        wc = w[0] if up else w
        conv = _time_cuda(
            lambda: torch.nn.functional.conv2d(xc, wc, padding=1), flush=flush
        )
        flops, nbytes = pmc_cost(H, Ci, Co, up, B, x.element_size())
        f32, tc, by = pmc_bounds(H, Ci, Co, up, B, dtype)
        rows.append(dict(stage=label, ms=ms, plain_ms=plain_ms, f32_ms=f32,
                         bound_ms=tc, bound_by=by, flops=flops, bytes=nbytes))
        bounds = (f"bf16 bound {tc:.4f} ms ({by}, share {tc / ms:.3f})"
                  if dtype == torch.bfloat16 else
                  f"f32 bound {f32:.4f} ms (share {f32 / ms:.3f})  "
                  f"3xTF32 bound {tc:.4f} ms ({by}, share {tc / ms:.3f})")
        log(f"[time] {dt} B={B} patch_mod_conv3 {label:15s} tile {th}x{tw} "
            f"splits {splits:2d}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"{bounds}  [F.conv2d {dt} one phase's shape, other function: "
            f"{conv:.4f} ms]")
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


def phase_swap_batch(bf16=False):
    """swap_batch of 8 distinct uint8 pairs at 1024^2 in one chunk of 8 and
    in chunks of 1 (each warmed up once, then timed twice); 13 launches per
    chunk (all of the bf16 kernel with ``bf16``). Returns swaps/s per chunk
    size."""
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    dt = "bf16" if bf16 else "f32"
    swapper = FaceSwapper(_opts(1024, 18, bf16=bf16), device="cuda", seed=0)
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
            _reset_launches()
            t0 = time.perf_counter()
            out = swapper.swap_batch(src, tgt, chunk=chunk)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            launches, n_bf16 = _launch_counts()
            want = PMC_LAUNCHES_PER_SWAP * (len(src) // chunk)
            if launches != want or n_bf16 != (want if bf16 else 0):
                raise SystemExit(f"FAIL batch: {dt} chunk {chunk}: {launches} kernel "
                                 f"launches ({n_bf16} bf16), want {want} {dt}")
            if out.shape != src.shape or out.dtype != np.uint8:
                raise SystemExit(f"FAIL batch: result {out.shape} {out.dtype}")
            if not all(f.item() for f in finite):
                raise SystemExit("FAIL batch: non-finite face")
        distinct = len({out[i].tobytes() for i in range(len(out))})
        if distinct != len(out):
            raise SystemExit(f"FAIL batch: {distinct} distinct results of {len(out)}")
        rates[chunk] = [len(src) / t for t in runs]
        log(f"[batch] {dt} swap_batch 8 pairs 1024^2 uint8, chunk {chunk}: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in runs)} ms "
            f"({', '.join(f'{r:.3f}' for r in rates[chunk])} swaps/s), "
            f"{launches} launches ({launches * chunk // len(src)} per chunk, bf16 "
            f"{n_bf16}), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[batch] {dt} swaps/s chunk 8 over chunk 1: "
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


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _launch_counts():
    from e4s_tpu_torch.ops.patch_modconv import patch_mod_conv3_nhwc

    return patch_mod_conv3_nhwc.launches, patch_mod_conv3_nhwc.launches_bf16


def _reset_launches():
    from e4s_tpu_torch.ops.patch_modconv import patch_mod_conv3_nhwc

    patch_mod_conv3_nhwc.launches = patch_mod_conv3_nhwc.launches_bf16 = 0


def phase_bf16_swaps():
    """FaceSwapper with ``bf16`` at 1024^2 answers 3 requests, each with 13
    launches of the bf16 instantiation. Returns the launches of a request."""
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    t0 = time.perf_counter()
    swapper = FaceSwapper(_opts(1024, 18, bf16=True), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[bf16] FaceSwapper 1024^2 bf16 built in {time.perf_counter() - t0:.1f} s")
    if swapper.latent_avg.dtype != torch.bfloat16:
        raise SystemExit("FAIL bf16: latent_avg is not bfloat16")
    finite = _finite_hook(swapper)
    src = os.path.join(EXAMPLE, "source.jpg")
    tgt = os.path.join(EXAMPLE, "target.jpg")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for r in range(3):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        arr = np.asarray(swapper.swap(src, tgt))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        total, bf16 = _launch_counts()
        log(f"[bf16] request {r}{' (warm-up)' if r == 0 else ''}: {times[-1]:.1f} ms, "
            f"patch_mod_conv3 launches {total} (bf16 {bf16}), mean pixel {arr.mean():.2f}")
        S = swapper.opts.out_size
        if arr.shape != (S, S, 3) or arr.dtype != np.uint8:
            raise SystemExit(f"FAIL bf16: result {arr.shape} {arr.dtype}")
        if not finite[-1].item():
            raise SystemExit("FAIL bf16: non-finite face before the uint8 cast")
        if total != PMC_LAUNCHES_PER_SWAP or bf16 != total:
            raise SystemExit(f"FAIL bf16: {total} launches ({bf16} bf16), want "
                             f"{PMC_LAUNCHES_PER_SWAP} bf16")
    log(f"[bf16] ms per 1024^2 bf16 swap (requests 1-2): "
        f"{', '.join(f'{t:.1f}' for t in times[1:])}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del swapper
    torch.cuda.empty_cache()
    return bf16


def phase_bf16_vs_cpu_and_f32():
    """The seeded swapper at 256^2: bf16 on the card against bf16 on the
    CPU (the plain versions), and bf16 against f32 on the card; >= 40 dB."""
    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper

    src = os.path.join(EXAMPLE, "source.jpg")
    tgt = os.path.join(EXAMPLE, "target.jpg")
    out = {}
    for dev, bf16 in (("cuda", True), ("cpu", True), ("cuda", False)):
        t0 = time.perf_counter()
        swapper = FaceSwapper(_opts(256, 14, bf16=bf16), device=dev, seed=1)
        out[dev, bf16] = np.asarray(swapper.swap(src, tgt))
        log(f"[bf16] 256^2 swap on {dev}, {'bf16' if bf16 else 'f32'}: "
            f"{time.perf_counter() - t0:.1f} s (build included)")
        del swapper
    for name, a, b in (("bf16 cuda vs bf16 cpu", out["cuda", True], out["cpu", True]),
                       ("bf16 cuda vs f32 cuda", out["cuda", True], out["cuda", False])):
        psnr = _psnr(a, b)
        log(f"[bf16] {name}: uint8 PSNR {psnr:.2f} dB, max |diff| "
            f"{np.abs(a.astype(np.int32) - b.astype(np.int32)).max()}")
        if psnr < 40.0:
            raise SystemExit(f"FAIL bf16: {name} PSNR {psnr:.2f} dB < 40")


EDIT_EXAMPLE = os.path.join("example", "input", "faceedit")
EDIT_ALPHAS = [0.0, 1 / 3, 2 / 3, 1.0]


def _edit_opts(out_size, n_styles):
    return _opts(out_size, n_styles, regions=["hair", "eyes"], alpha=1.0,
                 source=os.path.join(EDIT_EXAMPLE, "source.jpg"),
                 reference=os.path.join(EDIT_EXAMPLE, "reference.jpg"))


def phase_edit_sweep():
    """The edit sweep at 1024^2 (4 alphas, one batch): 13 launches, ms,
    peak memory; then the sweep at 256^2 on the card against the CPU."""
    from e4s_tpu_torch.pipelines.face_edit import Editor

    t0 = time.perf_counter()
    editor = Editor(_edit_opts(1024, 18), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[edit] Editor 1024^2 built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for r in range(3):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        imgs = editor.interpolation_sweep(EDIT_ALPHAS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        total, _ = _launch_counts()
        arrs = [np.asarray(i) for i in imgs]
        log(f"[edit] sweep {r}{' (warm-up)' if r == 0 else ''} of {len(arrs)} alphas: "
            f"{times[-1]:.1f} ms, patch_mod_conv3 launches {total}, mean pixels "
            f"{', '.join(f'{a.mean():.2f}' for a in arrs)}")
        S = editor.opts.out_size
        if len(arrs) != len(EDIT_ALPHAS) or any(a.shape != (S, S, 3) for a in arrs):
            raise SystemExit("FAIL edit: results of the wrong number or shape")
        if total != PMC_LAUNCHES_PER_SWAP:
            raise SystemExit(f"FAIL edit: {total} launches for the sweep, want "
                             f"{PMC_LAUNCHES_PER_SWAP}")
    if _psnr(arrs[0], arrs[-1]) > 60:
        raise SystemExit("FAIL edit: alpha 0 and alpha 1 give the same image")
    log(f"[edit] ms per 1024^2 sweep of 4 (sweeps 1-2): "
        f"{', '.join(f'{t:.1f}' for t in times[1:])}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del editor
    torch.cuda.empty_cache()
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        editor = Editor(_edit_opts(256, 14), device=dev, seed=1)
        out[dev] = [np.asarray(i) for i in editor.interpolation_sweep(EDIT_ALPHAS)]
        log(f"[edit] 256^2 sweep on {dev}: {time.perf_counter() - t0:.1f} s "
            "(build included)")
        del editor
    psnr = min(_psnr(a, b) for a, b in zip(out["cuda"], out["cpu"]))
    log(f"[edit] 256^2 sweep cuda vs cpu: uint8 PSNR {psnr:.2f} dB (worst of 4)")
    if psnr < 40.0:
        raise SystemExit(f"FAIL edit: PSNR {psnr:.2f} dB < 40")


def _optim_opts(out_size, n_styles, **kw):
    """The inversion's options (the dataset is given, nothing is saved)."""
    return _opts(out_size, n_styles, lr=0.01, opt_name="adam",
                 optimize_noise=False, lpips_lambda=0.8, id_lambda=0.1,
                 id_loss_multiscale=True, face_parsing_lambda=0.1,
                 l2_lambda=1.0, ir_se50_path=None, face_parsing_model_path=None,
                 **kw)


def _timed_invertion(opt, sample):
    """``opt.invertion(sample)`` with each step's end marked (the card
    synchronised) through the optimizer's update; returns (losses, ms per
    step from the second on, launches per step's forward)."""
    from e4s_tpu_torch.pipelines import optimization

    marks = []
    step = optimization.OptaxRule.step

    def marked(rule):
        step(rule)
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _launch_counts()[0]))

    optimization.OptaxRule.step = marked
    try:
        _reset_launches()
        _, recon, losses = opt.invertion(sample, save=False)
    finally:
        optimization.OptaxRule.step = step
    if not torch.isfinite(recon).all():
        raise SystemExit("FAIL inversion: non-finite face")
    ms = [(b[0] - a[0]) * 1e3 for a, b in zip(marks, marks[1:])]
    per_step = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    return losses, ms, per_step


def phase_inversion():
    """5 inversion steps at 1024^2 in f32 and in bf16; then 3 steps at 256^2
    on the card and on the CPU in f32, the losses within 1e-3 relative."""
    from e4s_tpu_torch.datasets.dataset import SyntheticFaceDataset
    from e4s_tpu_torch.pipelines.optimization import Optimizer

    for bf16 in (False, True):
        dt = "bf16" if bf16 else "f32"
        t0 = time.perf_counter()
        opt = Optimizer(_optim_opts(1024, 18, W_steps=5, bf16=bf16),
                        dataset=SyntheticFaceDataset(size=1024), device="cuda", seed=0)
        torch.cuda.synchronize()
        log(f"[invert] Optimizer 1024^2 {dt} built in {time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        losses, ms, per_step = _timed_invertion(opt, 1)
        total, n_bf16 = _launch_counts()
        log(f"[invert] 1024^2 {dt} losses per step: "
            f"{', '.join(f'{v:.6f}' for v in losses)}")
        log(f"[invert] 1024^2 {dt} ms per step (steps 2-5): "
            f"{', '.join(f'{t:.1f}' for t in ms)}; launches per step's forward "
            f"{per_step}; launches in all {total} (bf16 {n_bf16}); peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if len(losses) != 5 or not np.isfinite(losses).all():
            raise SystemExit(f"FAIL inversion: {dt} losses {losses}")
        if any(n != PMC_LAUNCHES_PER_SWAP for n in per_step):
            raise SystemExit(f"FAIL inversion: {dt} launches per step {per_step}")
        if (n_bf16 == total) != bf16 or total != PMC_LAUNCHES_PER_SWAP * 7:
            raise SystemExit(f"FAIL inversion: {dt} {total} launches ({n_bf16} bf16), "
                             f"want {PMC_LAUNCHES_PER_SWAP * 7} (2 reconstructions, "
                             "5 steps)")
        del opt
        torch.cuda.empty_cache()
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        opt = Optimizer(_optim_opts(256, 14, W_steps=3),
                        dataset=SyntheticFaceDataset(size=256), device=dev, seed=1)
        out[dev] = opt.invertion(1, save=False)[2]
        log(f"[invert] 256^2 f32 on {dev}: losses "
            f"{', '.join(f'{v:.6f}' for v in out[dev])} in "
            f"{time.perf_counter() - t0:.1f} s (build included)")
        del opt
    rel = float(np.max(np.abs(out["cuda"] - out["cpu"]) / np.abs(out["cpu"])))
    log(f"[invert] 256^2 losses cuda vs cpu: max relative difference {rel:.3e} "
        "(limit 1e-3)")
    if not np.isfinite(out["cuda"]).all() or rel > 1e-3:
        raise SystemExit(f"FAIL inversion: card vs CPU losses {rel:.3e} apart")


# training: loss weights of the training options' defaults
TRAIN_STEPS = 5  # steps 0-4: D every step, R1 at steps 0, 2, 4
TRAIN_DIR = os.path.join("work_dir", "chip_smoke_train")


def _train_opts(exp_dir, **kw):
    from e4s_tpu_torch.options.train_options import TrainOptions

    opts = TrainOptions().parse([
        "--exp_dir", exp_dir, "--dataset_name", "synthetic", "--d_every", "1",
        "--d_reg_every", "2", "--image_interval", "0", "--board_interval", "1",
        "--checkpoint_path", "", "--stylegan_weights", ""])
    for k, v in kw.items():
        setattr(opts, k, v)
    return opts


class _StepMeter:
    """Wraps a Coach's G, D and R1 steps: each ends in a synchronise and
    records its host ms, the kernel launches inside it (all, bf16) and its
    losses; and, inside a G step, the ms (CUDA events) of building the
    masked conv's kernel weights per call and of the kernel's plain
    backward (``_PatchModConv3.backward``)."""

    def __init__(self, coach):
        from e4s_tpu_torch.models import stylegan2
        from e4s_tpu_torch.ops import patch_modconv as pmc

        self.rows = {"g": [], "d": [], "r1": []}
        self.events = {"build": [], "backward": []}
        self._undo = []
        for name, key in (("_g_step", "g"), ("_d_step", "d"), ("_d_r1_step", "r1")):
            setattr(coach, name, self._timed(getattr(coach, name), key))

        def evented(fn, key):
            def run(*a, **kw):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*a, **kw)
                end.record()
                self.events[key].append((start, end))
                return out
            return run

        build, bwd = stylegan2.masked_conv_weights, pmc._PatchModConv3.backward
        stylegan2.masked_conv_weights = evented(build, "build")
        pmc._PatchModConv3.backward = staticmethod(evented(bwd, "backward"))
        self._undo = [(stylegan2, "masked_conv_weights", build),
                      (pmc._PatchModConv3, "backward", staticmethod(bwd))]

    def close(self):
        for obj, name, fn in self._undo:
            setattr(obj, name, fn)

    def _timed(self, fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            _reset_launches()
            for ev in self.events.values():
                ev.clear()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            row = dict(ms=ms, launches=_launch_counts(),
                       losses={k: float(v) for k, v in out.items()})
            if key == "g":
                row.update({k: sum(a.elapsed_time(b) for a, b in ev)
                            for k, ev in self.events.items()},
                           n_build=len(self.events["build"]),
                           n_backward=len(self.events["backward"]))
            self.rows[key].append(row)
            return out
        return run


def _train_run(label, opts):
    """``Coach.train()`` for TRAIN_STEPS steps; checks and prints the steps;
    returns the Coach."""
    from e4s_tpu_torch.training.coach import Coach

    t0 = time.perf_counter()
    coach = Coach(opts)
    torch.cuda.synchronize()
    log(f"[train] {label}: Coach built in {time.perf_counter() - t0:.1f} s "
        f"(DDP {coach.distributed}, world {coach.world}, latent_avg from "
        f"{opts.latent_avg_samples} samples)")
    meter = _StepMeter(coach)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        coach.train(max_steps=TRAIN_STEPS - 1)
    finally:
        meter.close()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = meter.rows
    bf16 = opts.bf16
    log(f"[train] {label}: {TRAIN_STEPS} steps with validation and two "
        f"checkpoints in {time.perf_counter() - t0:.1f} s; peak device memory "
        f"{peak:.2f} GiB")
    for key in ("g", "d", "r1"):
        for i, r in enumerate(rows[key]):
            extra = ""
            if key == "g":
                extra = (f"; kernel weights built {r['n_build']}x in "
                         f"{r['build']:.2f} ms, plain backward {r['n_backward']}x "
                         f"in {r['backward']:.2f} ms")
            log(f"[train] {label} {key} step {i}: {r['ms']:.1f} ms, launches "
                f"{r['launches'][0]} (bf16 {r['launches'][1]}){extra}; "
                + " ".join(f"{k}={v:.5g}" for k, v in r["losses"].items()))
    n_r1 = (TRAIN_STEPS + 1) // 2
    if [len(rows[k]) for k in ("g", "d", "r1")] != [TRAIN_STEPS, TRAIN_STEPS, n_r1]:
        raise SystemExit(f"FAIL train {label}: steps {[len(v) for v in rows.values()]}")
    for key in ("g", "d", "r1"):
        for r in rows[key]:
            if not all(np.isfinite(v) for v in r["losses"].values()):
                raise SystemExit(f"FAIL train {label}: non-finite {key} losses")
            want = 0 if key == "r1" else PMC_LAUNCHES_PER_SWAP
            if r["launches"] != (want, want if bf16 else 0):
                raise SystemExit(f"FAIL train {label}: {key} step launches "
                                 f"{r['launches']}, want {want} ({'bf16' if bf16 else 'f32'})")
    warm = {k: [r["ms"] for r in v[1:]] for k, v in rows.items()}
    g = rows["g"][1:]
    g_ms = float(np.mean([r["ms"] for r in g]))
    build = float(np.mean([r["build"] for r in g]))
    bwd = float(np.mean([r["backward"] for r in g]))
    log(f"[train] {label} ms per step, warm: G "
        f"{', '.join(f'{t:.1f}' for t in warm['g'])}; D "
        f"{', '.join(f'{t:.1f}' for t in warm['d'])}; R1 "
        f"{', '.join(f'{t:.1f}' for t in warm['r1'])}")
    log(f"[train] {label} masked-conv backward costs per G step (warm mean): "
        f"kernel weights built per call {build:.2f} ms ({build / g_ms:.3f} of "
        f"the step), plain backward {bwd:.2f} ms ({bwd / g_ms:.3f}); G step "
        f"{g_ms:.1f} ms")
    return coach


def phase_training():
    """Phase 15: 5 training steps at full width in f32 under a one-process
    NCCL group (DDP), then in bf16; the f32 checkpoint loads into a swap."""
    import shutil
    import socket

    import torch.distributed as dist

    from e4s_tpu_torch.pipelines.face_swap import FaceSwapper
    from e4s_tpu_torch.training.coach import init_distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # what torchrun --nproc_per_node 1 sets
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    device = init_distributed("cuda")
    try:
        coach = _train_run("f32 DDP", _train_opts(os.path.join(TRAIN_DIR, "f32"),
                                                   device=device))
        ckpt = os.path.join(coach.checkpoint_dir, "best_model.pt")
        del coach
        torch.cuda.empty_cache()
        coach = _train_run("bf16 DDP", _train_opts(os.path.join(TRAIN_DIR, "bf16"),
                                                    device=device, bf16=True))
        del coach
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    opts = _opts(1024, 18)
    opts.checkpoint_path = ckpt
    swapper = FaceSwapper(opts, device="cuda")
    _reset_launches()
    img = np.asarray(swapper.swap(os.path.join(EXAMPLE, "source.jpg"),
                                  os.path.join(EXAMPLE, "target.jpg")))
    launches = _launch_counts()[0]
    log(f"[train] trained checkpoint ({os.path.getsize(ckpt) / 2**30:.2f} GiB) -> "
        f"FaceSwapper 1024^2: launches {launches}, mean pixel {img.mean():.2f}")
    if img.shape != (1024, 1024, 3) or launches != PMC_LAUNCHES_PER_SWAP:
        raise SystemExit(f"FAIL train: swap from the checkpoint {img.shape}, "
                         f"{launches} launches")
    del swapper
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_training_vs_cpu():
    """Phase 16: one G and one D step at 64^2 on the card and on the CPU,
    each from the same seeded weights, batch and noise (the registered
    maps)."""
    from e4s_tpu_torch.datasets.dataset import SyntheticFaceDataset, label_map_to_onehot
    from e4s_tpu_torch.training.coach import Coach

    ds = SyntheticFaceDataset(size=64)
    img = np.stack([ds[i][0] for i in (1, 2)])
    label = np.stack([ds[i][1] for i in (1, 2)]).astype(np.int32)
    batch = (img, label, label_map_to_onehot(label, 12))
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        opts = _train_opts(os.path.join(TRAIN_DIR, dev), device=dev, out_size=64,
                           remaining_layer_idx=7, n_styles=10, encoder_size=64,
                           id_lambda=0.0, face_parsing_lambda=0.0,
                           w_norm_lambda=0.01, latent_avg_samples=256)
        img_t, label_t, onehot_t = (torch.from_numpy(a).to(dev) for a in batch)
        out = {}
        for key in ("g", "d"):  # each from the seeded weights
            coach = Coach(opts)
            G = coach.net.G
            noise = [getattr(G.noises, f"noise_{i}") for i in range(G.num_layers)]
            if key == "g":
                m, step = coach.net, lambda: coach._g_step(img_t, label_t, onehot_t,
                                                           noise=noise)
            else:
                m, step = coach.D, lambda: coach._d_step(img_t, onehot_t, noise=noise)
            before = {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
            _reset_launches()
            losses = {k: float(v) for k, v in step().items()}
            after = {n: p.detach().cpu() for n, p in m.named_parameters()}
            out[key] = (losses, {n: torch.sign(after[n] - before[n]) for n in before},
                        _launch_counts()[0])
            del coach
        res[dev] = out
        log(f"[train] 64^2 steps on {dev}: {time.perf_counter() - t0:.1f} s (builds "
            f"included); G launches {out['g'][2]}, D launches {out['d'][2]}")
    for key in ("g", "d"):
        (lc, sc, nc), (lp, sp, _) = res["cuda"][key], res["cpu"][key]
        # relative above 1, absolute below: D's scores are means of logits
        # near 0
        errs = {k: abs(lc[k] - lp[k]) / max(abs(lp[k]), 1.0) for k in lp}
        worst = max(errs, key=errs.get)
        rel = errs[worst]
        differ = sum(int((sc[n] != sp[n]).sum()) for n in sp)
        total = sum(t.numel() for t in sp.values())
        log(f"[train] 64^2 {key} step cuda vs cpu: losses within {rel:.3e} of "
            f"max(|cpu|, 1) (limit 1e-4; worst {worst}: {lc[worst]:.7g} against "
            f"{lp[worst]:.7g}); update signs differ in {differ} of {total} "
            f"elements ({differ / total:.2e}, limit 1e-2); card launches {nc}")
        if set(lc) != set(lp) or rel > 1e-4 or differ > 1e-2 * total or nc != 7:
            raise SystemExit(f"FAIL train: 64^2 {key} step card vs CPU")


def _per_swap_line(rows, launches, B=1, dtype=torch.float32):
    def total(key):
        return sum(r[key] for r in rows)

    bounds = (f"bf16 bound {total('bound_ms'):.4f} ms" if dtype == torch.bfloat16
              else f"f32 bound {total('f32_ms'):.4f} ms, 3xTF32 bound "
                   f"{total('bound_ms'):.4f} ms")
    log(f"[time] {_dt(dtype)} B={B} patch_mod_conv3 per swap pass ({launches} "
        f"launches): kernel {total('ms'):.4f} ms, plain "
        f"{total('plain_ms'):.4f} ms, {bounds} (sums of per-launch bounds; "
        f"share {total('bound_ms') / total('ms'):.3f})")
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
    bf16 = torch.bfloat16
    worst16 = max(phase_kernel_vs_plain(1, bf16), phase_kernel_vs_plain(8, bf16))
    rows16 = phase_kernel_times(1, bf16)
    per_swap16 = _per_swap_line(rows16, PMC_LAUNCHES_PER_SWAP, 1, bf16)
    _per_swap_line(phase_kernel_times(8, bf16), PMC_LAUNCHES_PER_SWAP, 8, bf16)
    t_ops16 = sum(r["flops"] for r in rows16) / PEAK_BF16_FLOPS * 1e3
    t_bytes16 = sum(r["bytes"] for r in rows16) / PEAK_BYTES * 1e3
    launches16 = phase_bf16_swaps()
    phase_bf16_vs_cpu_and_f32()
    phase_edit_sweep()
    phase_inversion()
    phase_swap_batch(bf16=True)
    # training's batch: the K-splits are planned from B
    worst = max(worst, phase_kernel_vs_plain(B=2))
    worst16 = max(worst16, phase_kernel_vs_plain(2, bf16))
    phase_training()
    phase_training_vs_cpu()
    row = dict(route="cuda", replaces="e4s_tpu/ops/pallas/modconv_tpu.py:39",
               library_ms=None)
    summary = {"kernels": [{
        "name": "patch_mod_conv3", **row,
        "source": "e4s_tpu_torch/csrc/patch_mod_conv3.cu",
        "launches": launches,
        "max_abs_err": worst,
        "ms": per_swap("ms"),
        "plain_ms": per_swap("plain_ms"),
        "bound_ms": per_swap("bound_ms"),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }, {
        "name": "patch_mod_conv3_bf16", **row,
        "source": "e4s_tpu_torch/csrc/patch_mod_conv3_bf16.cu",
        "launches": launches16,
        "max_abs_err": worst16,
        "ms": per_swap16("ms"),
        "plain_ms": per_swap16("plain_ms"),
        "bound_ms": per_swap16("bound_ms"),
        "bound_by": "operations" if t_ops16 >= t_bytes16 else "bytes",
    }]}
    log(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
