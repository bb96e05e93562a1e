"""Times the conv3x3 kernel (``csrc/conv3_tf32.cu``) under every launch
plan its C entry takes, at each stride-1 3x3 shape of the texture encoder,
on one GPU, and checks each plan's result against the plain version:

    python3 scripts/sweep_conv3_plans.py [--batch 2 16]

A plan is (pixel tile, K splits summed by a second pass). For each shape
and batch size it prints one line per plan with the CUDA-event time of one
launch (20 calls, each behind an overwrite of a 1 GiB buffer, so every
call starts with a cold L2, as ``chip_smoke.py`` times it), its share of
the 3xTF32 bound and its max |kernel - plain| against max |plain|, and
marks the plan ``ops/conv3x3.py::plan`` picks and the fastest. The sums
over the encoder's 44 convs of the picked and of the fastest plans close
each batch size.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from e4s_tpu_torch.ops import conv3x3 as c3  # noqa: E402
from e4s_tpu_torch.ops import patch_modconv as pmc  # noqa: E402


def plans(Ci):
    steps = -(-Ci // c3.TILE_K)
    for th, tw in c3.TILES:
        for splits in (1, 2, 4, 8, 16):
            if splits == 1 or steps >= 2 * splits:
                yield th, tw, splits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_card()
    cs.phase_build()
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    picked_plan = c3.plan
    bad = []
    try:
        for B in args.batch:
            sum_pick = sum_best = sum_bound = 0.0
            for i, (label, H, Ci, Co, n) in enumerate(cs.ENCODER_CONVS):
                g = torch.Generator(device="cuda").manual_seed(200 + i)
                x = torch.randn((B, H, H, Ci), generator=g, device="cuda")
                w = torch.randn((Co, Ci, 3, 3), generator=g, device="cuda") / math.sqrt(9 * Ci)
                packed = pmc.pack_weight(w)
                want = c3.conv3x3_nhwc_plain(x, w)
                scale = want.abs().max().item()
                pick = picked_plan(B, H, H, Ci, Co, sms)
                bound = cs.conv3_bounds(B, H, Ci, Co)[2]
                times = {}
                for plan in plans(Ci):
                    c3.plan = lambda *a, plan=plan: plan
                    err = (c3.conv3x3_nhwc(x, w, packed) - want).abs().max().item()
                    if not err <= 1e-4 * scale:
                        bad.append((B, label, plan, err, scale))
                    times[plan] = cs._time_cuda(lambda: c3.conv3x3_nhwc(x, w, packed),
                                                flush=flush)
                    print(f"[sweep] B={B} {label:15s} tile {plan[0]}x{plan[1]} "
                          f"splits {plan[2]:2d}: {times[plan]:.4f} ms (share "
                          f"{bound / times[plan]:.3f}) max|diff| {err:.3e} of "
                          f"{scale:.3e}{' <- plan' if plan == pick else ''}", flush=True)
                c3.plan = picked_plan
                best = min(times, key=times.get)
                print(f"[sweep] B={B} {label:15s} x{n}: picked {pick} {times[pick]:.4f} ms, "
                      f"fastest {best} {times[best]:.4f} ms, bound {bound:.4f} ms",
                      flush=True)
                sum_pick += n * times[pick]
                sum_best += n * times[best]
                sum_bound += n * bound
                del x, w, packed, want
                torch.cuda.empty_cache()
            print(f"[sweep] B={B} the encoder's {cs.CONV3_LAUNCHES_PER_PASS} convs: picked "
                  f"plans {sum_pick:.4f} ms (share {sum_bound / sum_pick:.3f}), fastest "
                  f"plans {sum_best:.4f} ms (share {sum_bound / sum_best:.3f}), bound "
                  f"{sum_bound:.4f} ms", flush=True)
    finally:
        c3.plan = picked_plan
    if bad:
        raise SystemExit(f"FAIL sweep: plans off the plain version: {bad}")


if __name__ == "__main__":
    main()
