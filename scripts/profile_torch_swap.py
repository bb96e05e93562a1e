"""Where the time of one 1024^2 swap of the PyTorch port goes, on one GPU.

    python3 scripts/profile_torch_swap.py [--requests 5] [--segnext] [--lap_bld]

Builds ``e4s_tpu_torch``'s FaceSwapper at 1024^2 (K=13, 18 styles, seeded
random weights, TF32 off; the BiSeNet parser and the feathered stitch, or
with ``--segnext`` the SegNeXt-small parser and with ``--lap_bld`` the
Laplacian blend), warms up, then over ``--requests`` swaps of the example
pair reports:

  - host time per request, split into image loading (PIL decode + resize)
    and the fused swap (upload, device work, download);
  - device time of each stage (parse, RGI encoder, LocalMLPs, synthesis,
    the Laplacian blend with ``--lap_bld``, and the rest: mask swap,
    stitch masks, casts), from CUDA events recorded around each stage;
  - from ``torch.profiler`` over one request: device busy time (sum of
    kernel times), the idle share of the request's wall time, and the
    kernels that take most device time.

The profiler's full table goes to ``chiprun_out/profile_torch_swap.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import types
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from e4s_tpu_torch.pipelines import swap_core  # noqa: E402
from e4s_tpu_torch.pipelines.face_swap import FaceSwapper  # noqa: E402

EXAMPLE = os.path.join("example", "input", "faceswap")


def _record(events, name):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    events[name].append([e, None])


def _close(events, name):
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    events[name][-1][1] = e


def stage_timers(swapper):
    """Forward hooks that record a CUDA event pair around each stage's
    modules, and the same around the Laplacian blend; returns the
    per-request event lists."""
    events = defaultdict(list)
    parser = type(swapper.parser.model).__name__
    stages = {f"parse ({parser})": [swapper.parser.model],
              "encoder (RGI)": [swapper.net.encoder],
              "LocalMLPs": list(swapper.net.MLPs),
              "synthesis (G)": [swapper.net.G]}
    for name, mods in stages.items():
        for m in mods:
            m.register_forward_pre_hook(lambda mod, args, name=name: _record(events, name))
            m.register_forward_hook(lambda mod, args, out, name=name: _close(events, name))
    blend = swap_core.blend_images

    def timed_blend(*args, **kw):
        _record(events, "Laplacian blend")
        out = blend(*args, **kw)
        _close(events, "Laplacian blend")
        return out

    swap_core.blend_images = timed_blend  # looked up at call time
    return events


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--segnext", action="store_true",
                    help="the SegNeXt-small parser instead of BiSeNet")
    ap.add_argument("--lap_bld", action="store_true",
                    help="the Laplacian blend instead of the feathered stitch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[profile] {torch.cuda.get_device_name(0)}", flush=True)

    opts = types.SimpleNamespace(
        num_seg_cls=12, out_size=1024, remaining_layer_idx=13, n_styles=18,
        start_from_latent_avg=True, checkpoint_path=None, faceParsing_ckpt=None,
        faceParser_name="segnext" if args.segnext else "default",
        segnext_variant="small", lap_bld=args.lap_bld,
    )
    swapper = FaceSwapper(opts, device="cuda", seed=0)
    src, tgt = (os.path.join(EXAMPLE, f) for f in ("source.jpg", "target.jpg"))
    for _ in range(2):
        swapper.swap(src, tgt)
    torch.cuda.synchronize()

    events = stage_timers(swapper)
    load_ms, swap_ms, total_dev = [], [], []
    for _ in range(args.requests):
        for v in events.values():
            v.clear()
        t0 = time.perf_counter()
        S01, T01 = swapper._load(src), swapper._load(tgt)
        t1 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        swapper.swap_from_arrays(S01, T01)
        end.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        load_ms.append((t1 - t0) * 1e3)
        swap_ms.append((t2 - t1) * 1e3)
        total_dev.append(start.elapsed_time(end))
    n = args.requests
    print(f"[profile] host ms per request: load {sum(load_ms) / n:.2f}, fused "
          f"swap {sum(swap_ms) / n:.2f} (device span {sum(total_dev) / n:.2f})")
    # the last request's stage spans on the device clock
    staged = 0.0
    for name, pairs in events.items():
        ms = sum(a.elapsed_time(b) for a, b in pairs)
        staged += ms
        print(f"[profile] stage {name:16s} {ms:8.2f} ms device span "
              f"({len(pairs)} calls)")
    print(f"[profile] stage {'rest':16s} {total_dev[-1] - staged:8.2f} ms "
          f"(mask swap, one-hots, stitch masks, casts, copies)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        swapper.swap_from_arrays(S01, T01)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] profiled request: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms (sum of kernel times), idle share "
          f"{1 - busy / wall:.3f}")
    h2d = [e for e in kernels if "Memcpy HtoD" in e.key]
    print(f"[profile] host-to-device copies: {sum(e.count for e in h2d)} "
          f"({sum(e.self_device_time_total for e in h2d) / 1e3:.3f} ms)")
    rows = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    for e in rows[:15]:
        print(f"[profile] {e.self_device_time_total / 1e3:8.3f} ms  "
              f"x{e.count:4d}  {e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_swap.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=60))


if __name__ == "__main__":
    main()
