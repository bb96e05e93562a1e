"""Where the 1024^2 synthesis's device time goes, layer by layer, on one GPU.

    python3 scripts/profile_synthesis.py [--root DIR] [--batch 1 8] [--calls 3]

Builds the E4S generator (StyleGAN2-1024, channel multiplier 2, K = 13,
seeded random weights with random noise strengths and biases, TF32 off)
from the ``e4s_tpu_torch`` under ``--root`` (the checkout by default;
another tree, such as a parent commit unpacked beside it, to compare) and
runs one synthesis pass a call on a seeded W^{r+} latent and 12-region
mask, with the registered noise, as the swap does. For each batch it
reports, from ``torch.profiler`` over ``--calls`` calls:

  - the device time of a call, and of each unmasked layer a call: the
    four StyledConvs at 512^2 and 1024^2 (layers 13-16) and the ToRGBs at
    512^2 and 1024^2 with their skip ``upsample2``; a kernel's time counts
    toward the layer whose call launched it;
  - each of those layers' kernels by name, with launches a call, so that
    the transposed convs, the blurs (cuDNN's grouped conv) and the
    elementwise passes show apart.

It also prints the CUDA-event time of a call (5 warm calls back to back)
and, where the tree has it, the launches a call of the unmasked StyledConv
kernel (``ops/styled_conv.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

import torch


def _spans(G):
    """(span name, module) of every unmasked layer at 512^2 and 1024^2."""
    out = []
    for idx, s in ((6, 9), (7, 10)):
        i = 2 * s - 5
        out.append((f"styled_conv.{i} ({2 ** s}^2, up)", G.convs[2 * idx]))
        out.append((f"styled_conv.{i + 1} ({2 ** s}^2)", G.convs[2 * idx + 1]))
        out.append((f"to_rgb.{i + 2} ({2 ** s}^2, skip upsample2)", G.to_rgbs[idx]))
    return out


def _wrap(module, span):
    from torch.profiler import record_function

    forward = module.forward

    def inner(*a, **k):
        with record_function(span):
            return forward(*a, **k)
    module.forward = inner


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: needs a CUDA GPU")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, here)
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness.trace import kineto_events
    from e4s_tpu_torch.models.layers import init_module_
    from e4s_tpu_torch.models.stylegan2 import Generator

    try:
        from e4s_tpu_torch.ops.styled_conv import styled_conv3
    except ImportError:
        styled_conv3 = None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    G = init_module_(Generator(1024, remaining_layer_idx=13),
                     torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in G.modules():  # the init zeroes these; a trained model does not
            if type(m).__name__ == "NoiseInjection":
                m.weight.normal_(generator=gen)
            if type(m).__name__ == "FusedLeakyReLU":
                m.bias.normal_(generator=gen)
    G = G.to(dev).eval()
    spans = _spans(G)
    for name, m in spans:
        _wrap(m, name)
    names = [n for n, _ in spans] + ["synthesis"]
    print(f"[synth] {torch.cuda.get_device_name(0)}, tree {args.root}", flush=True)
    for B in args.batch:
        g = torch.Generator(device=dev).manual_seed(2)
        latent = torch.randn((B, 12, 18, 512), generator=g, device=dev)
        label = torch.randint(0, 12, (B, 32, 32), generator=g, device=dev)
        label = torch.nn.functional.interpolate(label[:, None].float(), (1024, 1024))
        mask = torch.nn.functional.one_hot(label[:, 0].long(), 12).permute(0, 3, 1, 2).float()

        def call():
            with record_function("synthesis"):
                return G([latent], None, mask, input_is_latent=True,
                         randomize_noise=False)[0]

        with torch.no_grad():
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(5):
                call()
            b.record()
            torch.cuda.synchronize()
            print(f"[synth] B={B} call {a.elapsed_time(b) / 5:.3f} ms (CUDA events, "
                  "5 warm calls back to back)", flush=True)
            if styled_conv3 is not None:
                styled_conv3.launches = 0
                call()
                print(f"[synth] B={B} styled_conv3 launches a call: "
                      f"{styled_conv3.launches}", flush=True)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    call()
                torch.cuda.synchronize()
        events = kineto_events(prof)
        launch = {e.corr: e.start for e in events if e.kind == "runtime" and e.corr}
        ranges = [e for e in events if e.kind == "range" and e.name in names]
        per = defaultdict(float)
        ops = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
        # the spans' own ranges on the device's timeline are not work
        for d in (e for e in events if e.kind == "device" and e.name not in names):
            t = launch.get(d.corr)
            if t is None:
                continue
            inside = [r for r in ranges if r.start <= t <= r.end]
            # the innermost layer span, else the whole synthesis
            inner = [r.name for r in inside if r.name != "synthesis"]
            for name in set(inner[:1] + [r.name for r in inside if r.name == "synthesis"]):
                per[name] += (d.end - d.start) / 1e6 / args.calls
                if name != "synthesis":
                    ops[name][d.name][0] += (d.end - d.start) / 1e6 / args.calls
                    ops[name][d.name][1] += 1 / args.calls
        total = per["synthesis"]
        print(f"[synth] B={B} device time a call: synthesis {total:.3f} ms "
              f"({args.calls} profiled calls)", flush=True)
        for name, _ in spans:
            print(f"[synth] B={B} {name:36s} {per[name]:9.3f} ms", flush=True)
            for op, (ms, n) in sorted(ops[name].items(), key=lambda kv: -kv[1][0]):
                print(f"[synth] B={B}     {ms:9.3f} ms {n:4.1f}x  {op[:120]}", flush=True)
        four = sum(per[n] for n, _ in spans if n.startswith("styled_conv"))
        print(f"[synth] B={B} the four unmasked StyledConvs: {four:.3f} ms of "
              f"{total:.3f}", flush=True)
        del latent, mask


if __name__ == "__main__":
    main()
