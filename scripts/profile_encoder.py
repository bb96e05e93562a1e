"""Where the texture encoder's device time goes, on one GPU.

    python3 scripts/profile_encoder.py [--root DIR] [--batch 16] [--calls 3]

Builds FSEncoderPSP (the 24-unit IR-SE trunk at 256^2, 12 regions, seeded
random weights, TF32 off) from the ``e4s_tpu_torch`` under ``--root`` (the
checkout by default; another tree, such as a parent commit unpacked beside
it, to compare), then at ``--batch`` images a call (16: the two faces of
``swap_batch``'s chunk of 8) reports:

  - the CUDA-event time of a call, mean of 5 warm calls, and the host's
    time to enqueue one call (from an idle card to the call's return, no
    synchronise): where it exceeds the device's, the call is host-bound;
  - from ``torch.profiler`` over ``--calls`` calls: the device busy time
    of a call, and every kernel by device time a call, with its launches
    a call, so that cuDNN's convs, the conv3x3 kernel and the layout copies
    (``copy``/``contiguous`` kernels, cuDNN's ``nchwToNhwc`` and
    ``nhwcToNchw``) show by name.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: needs a CUDA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from torch.profiler import ProfilerActivity, profile

    from e4s_tpu_torch.models.encoders import FSEncoderPSP
    from e4s_tpu_torch.models.layers import init_module_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    enc = init_module_(FSEncoderPSP(), torch.Generator().manual_seed(0)).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    B = args.batch
    x = torch.rand((B, 3, 256, 256), generator=g, device=dev) * 2 - 1
    label = torch.randint(0, 12, (B, 256, 256), generator=g, device=dev)
    seg = torch.nn.functional.one_hot(label, 12).permute(0, 3, 1, 2).float()
    name = torch.cuda.get_device_name(0)
    print(f"[encoder] {name}, tree {args.root}, B={B}", flush=True)
    with torch.no_grad():
        for _ in range(2):
            enc(x, seg)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            enc(x, seg)
        b.record()
        torch.cuda.synchronize()
        print(f"[encoder] B={B} call {a.elapsed_time(b) / 5:.3f} ms (CUDA events, "
              "5 warm calls back to back)", flush=True)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc(x, seg)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        print(f"[encoder] B={B} host enqueue {min(enqueue):.3f} ms a call (least "
              f"of 5; median {sorted(enqueue)[2]:.3f})", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.calls):
                enc(x, seg)
            torch.cuda.synchronize()
    rows = [(e.device_time_total / args.calls / 1e3, e.count / args.calls, e.key)
            for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[encoder] B={B} device busy {busy:.3f} ms a call "
          f"({args.calls} profiled calls)", flush=True)
    for ms, n, key in rows:
        print(f"[encoder] {ms:9.4f} ms {n:5.1f}x  {key[:150]}", flush=True)


if __name__ == "__main__":
    main()
