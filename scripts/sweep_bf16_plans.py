"""Times the bf16 masked-conv kernel under every launch plan its C entry
takes, at each of the 13 main-path stages, on one GPU:

    python3 scripts/sweep_bf16_plans.py [--batch 1 8]

A plan is (pixel tile, K splits reduced in a cluster). For each stage and
batch size it prints one line per plan with the CUDA-event time of one
launch (20 calls, each behind an overwrite of a 1 GiB buffer, so every
call starts with a cold L2, as ``chip_smoke.py`` times the kernel), marks
the plan ``plan_bf16`` picks and the fastest, and gives the kernel's own
duration under ``torch.profiler`` for the picked plan (CUPTI), so that
time spent between launches shows apart from time in the kernel. The sum
over the 13 stages of the picked and of the fastest plans closes each
batch size.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from e4s_tpu_torch.ops import patch_modconv as pmc  # noqa: E402

TILES = [(8, 8), (8, 16), (16, 16)]


def plans(Ci):
    chunks = -(-Ci // pmc.TILE_K[torch.bfloat16])
    for th, tw in TILES:
        for splits in (1, 2, 4, 8):
            if splits <= chunks:
                yield th, tw, splits


def profiled_ms(fn, flush, iters=20):
    """Mean device duration of the bf16 kernel per call under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if "patch_mod_conv3_bf16_kernel" in e.key)
    return total / iters / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_card()
    cs.phase_build()
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    picked_plan = pmc.plan_bf16
    try:
        for B in args.batch:
            sum_pick = sum_best = 0.0
            for i, (label, H, Ci, Co, up) in enumerate(cs.PMC_STAGES):
                kernel, _ = cs._pmc_entries(up)
                x, w, smap, dmap = cs._pmc_inputs(H, Ci, Co, up, seed=i, B=B,
                                                  dtype=torch.bfloat16)
                packed = pmc.pack_weight(w)
                pick = picked_plan(B, H, H, Ci, Co, 4 if up else 1, sms)
                _, bound, _ = cs.pmc_bounds(H, Ci, Co, up, B, torch.bfloat16)
                times = {}
                for plan in plans(Ci):
                    pmc.plan_bf16 = lambda *a, plan=plan: plan
                    times[plan] = cs._time_cuda(
                        lambda: kernel(x, w, smap, dmap, packed), flush=flush)
                pmc.plan_bf16 = picked_plan
                prof = profiled_ms(lambda: kernel(x, w, smap, dmap, packed), flush)
                best = min(times, key=times.get)
                for plan, ms in times.items():
                    mark = (" <- plan" if plan == pick else "") + (
                        " <- fastest" if plan == best else "")
                    print(f"[sweep] B={B} {label:15s} tile {plan[0]}x{plan[1]} "
                          f"splits {plan[2]}: {ms:.4f} ms "
                          f"(share {bound / ms:.3f}){mark}", flush=True)
                print(f"[sweep] B={B} {label:15s} picked plan {pick}: events "
                      f"{times[pick]:.4f} ms, profiler kernel {prof:.4f} ms; "
                      f"fastest {best} {times[best]:.4f} ms", flush=True)
                sum_pick += times[pick]
                sum_best += times[best]
            print(f"[sweep] B={B} per swap pass: picked plans {sum_pick:.4f} ms, "
                  f"fastest plans {sum_best:.4f} ms", flush=True)
    finally:
        pmc.plan_bf16 = picked_plan


if __name__ == "__main__":
    main()
